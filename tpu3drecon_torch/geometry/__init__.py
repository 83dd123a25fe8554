"""Geometry core: rotation algebra and robust losses."""
