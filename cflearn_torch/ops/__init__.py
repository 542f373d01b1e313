"""Ops layer of the port: attention and 3x3-conv dispatchers with their
hand-written CUDA kernels, and GroupNorm."""
