"""Kernels (CUDA, built at first use) with their plain PyTorch versions, and the causal convs."""
