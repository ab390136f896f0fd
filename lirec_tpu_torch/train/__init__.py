"""Training: the optimizer and the epoch loop (train/optim.py, train/loop.py)."""
