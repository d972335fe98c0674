"""Hand-written CUDA kernels (csrc/) and their ctypes loader (build.py)."""
