"""Hand-written Hopper kernels (CUDA C++ under ``*/csrc``), each with its
plain PyTorch version beside it."""
