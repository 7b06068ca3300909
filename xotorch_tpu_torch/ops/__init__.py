"""Numerical ops: plain PyTorch references and the wrappers of the CUDA kernels."""
