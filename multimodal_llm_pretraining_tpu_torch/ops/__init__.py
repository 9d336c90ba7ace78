"""Attention and loss ops: the CUDA kernels, their wrappers and plain versions."""
