"""Pair scorer and the loader of the hand-written CUDA kernels."""
