"""xotorch_tpu_torch: the PyTorch/CUDA port of xotorch_tpu for NVIDIA Hopper.

The JAX package (xotorch_tpu) is the reference; this package imports nothing from it
and keeps its own copies of what it needs. Entry points run on `cuda` unless the
caller asks for the CPU.
"""
VERSION = "0.1.0"
