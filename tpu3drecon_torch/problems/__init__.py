"""Packed problem containers and packers (flat, bucketed grid, dense and
windowed track table), camera reordering, and conversion from the JAX
package."""
