"""Spatial decompositions of the stacking kernels and the host <-> device
I/O pipeline (the JAX package's ``parallel/``)."""

from .fused import banded_warp_combine
from .pipeline import AsyncWriter, PrefetchLoader, stream_stacks

__all__ = ["banded_warp_combine", "AsyncWriter", "PrefetchLoader",
           "stream_stacks"]
