"""Flow numerics and per-pair reductions (PyTorch), the CUDA kernel
wrappers (``cuda/``) and the host signal chain."""
