"""LM / implicit-Schur bundle-adjustment solvers."""
