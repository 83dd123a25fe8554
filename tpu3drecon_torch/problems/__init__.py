"""Packed problem containers and packers (flat, bucketed grid, windowed
track table), camera reordering, and conversion from the JAX package."""
