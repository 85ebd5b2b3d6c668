"""Compute path of the PyTorch port: torus ops, key switch, blind rotation
(plain PyTorch and the CUDA kernel) and the lvl0 gate."""
