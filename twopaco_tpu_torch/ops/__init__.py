"""Plain PyTorch k-mer packing and hashing (the kernels' arithmetic)."""
