"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each beside its
plain PyTorch version. A wrapper takes the plain version only for tensors on
the CPU; for CUDA tensors it launches its kernel or raises."""
