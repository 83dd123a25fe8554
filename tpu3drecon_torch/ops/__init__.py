"""Kernels and per-observation math: analytic Jacobian blocks, the eight wtt
kernels (B1-B4 of the fully indexed route, B5-B8 of the unfused and one-hot
routes), the grid engine's three, the dense track table's five and the
flat engine's linearization (CUDA on a GPU tensor, the plain PyTorch
version on a CPU one)."""
