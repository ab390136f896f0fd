"""Data-parallel training and evaluation over torch.distributed
(counterpart of lirec_tpu/parallel/, its data axis): parallel/dist.py
(process groups, the data mesh, spawn) and parallel/step.py (the
DistributedDataParallel train step)."""
