"""Kernels and per-observation math: analytic Jacobian blocks, the four wtt
kernels, the grid engine's three and the dense track table's five (CUDA on
a GPU tensor, the plain PyTorch version on a CPU one)."""
