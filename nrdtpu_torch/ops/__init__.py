"""Shared image ops: stencils, resampling, tile maps."""
