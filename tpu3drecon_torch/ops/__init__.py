"""Kernels and per-observation math: analytic Jacobian blocks and the four
wtt kernels (CUDA on a GPU tensor, the plain PyTorch version on a CPU one)."""
