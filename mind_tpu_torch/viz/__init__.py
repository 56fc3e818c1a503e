"""Rendering of recorded frames (port of mind_tpu/viz)."""
