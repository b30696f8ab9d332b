"""Hand-written CUDA kernels (``csrc/``), their nvcc build and wrappers."""
