"""Thin command functions for dksraw (reference api/__init__.py:6-10)."""

from .commands import grey, rgb, split

__all__ = ["grey", "rgb", "split"]
