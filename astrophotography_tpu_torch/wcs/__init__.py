"""World coordinate systems and astrometry (host code; the local plate
solve maps through a device ``Similarity``)."""

from .wcs import TanWCS

__all__ = ["TanWCS"]
