"""Hand-written CUDA kernels, their plain versions and their build."""
