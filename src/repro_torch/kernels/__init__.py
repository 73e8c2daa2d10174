"""Kernels of the serving path: hand-written CUDA for CUDA tensors, the
plain PyTorch versions (``ref``) for CPU tensors. Model code calls ``ops``."""
