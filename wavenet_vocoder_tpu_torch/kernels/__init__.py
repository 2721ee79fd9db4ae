"""Lazy nvcc build and ctypes loading of the port's CUDA kernels."""
