"""Spatial decompositions of the stacking kernels (the JAX package's
``parallel/``)."""

from .fused import banded_warp_combine

__all__ = ["banded_warp_combine"]
