"""Benchmark configurations."""
