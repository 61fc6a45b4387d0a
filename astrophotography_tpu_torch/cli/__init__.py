"""Command-line entry points: dksraw + the ap_* calibration tools.

The CLI surface (command names, arguments, defaults) preserves the
reference's (reference cli.py and scripts/ap_*.py) so existing scripts
and muscle memory transfer; each tool adds ``--device`` (default
``cuda``) and the implementations run on the device ops.
"""
