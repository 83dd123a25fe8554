"""Kernels and per-observation math: analytic Jacobian blocks, the four wtt
kernels and the grid engine's three (CUDA on a GPU tensor, the plain
PyTorch version on a CPU one)."""
