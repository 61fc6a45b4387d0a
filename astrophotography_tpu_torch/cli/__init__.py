"""Command-line entry points: dksraw and the ap_* tools, every tool of
the JAX package.

The CLI surface (command names, arguments, defaults) preserves the
reference's (reference cli.py and scripts/ap_*.py) so existing scripts
and muscle memory transfer; each tool that computes adds ``--device``
(default ``cuda``) and the implementations run on the device ops.  The
three host-only tools (``ap_add_metadata``, ``ap_quality_summary``,
``ap_tidy_files``) have no device to choose.
"""
