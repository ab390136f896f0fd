"""Training and evaluation over torch.distributed (counterpart of
lirec_tpu/parallel/): parallel/mesh.py (the (data, model) process mesh,
the tensor-parallel plan, shard_model / gather_state and the two
tensor-parallel collectives), parallel/dist.py (process groups, spawn,
the data axis's row blocks) and parallel/step.py (the mesh train step:
the parameters broadcast over the data axis at its start, the gradients
summed over it by one all-reduce of flat buffers a step, capturable as a
CUDA graph over NCCL)."""
