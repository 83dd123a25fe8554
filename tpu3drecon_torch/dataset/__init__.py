"""Synthetic scenes with known ground truth."""
