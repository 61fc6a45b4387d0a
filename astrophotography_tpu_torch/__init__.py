"""astrophotography_tpu_torch — the PyTorch + CUDA port of astrophotography_tpu.

The JAX package (``astrophotography_tpu``) stays the reference; this
package re-implements its stacking paths, lean and unfused
(calibrate -> detect -> register -> warp -> sigma-clip stack), on
PyTorch tensors, with the JAX package's three TPU Pallas kernels
rewritten as hand-written CUDA C++ kernels for Hopper (``csrc/``).

Every kernel has a plain PyTorch twin beside it.  A wrapper runs the
plain version only for tensors that live on the CPU; for CUDA tensors it
builds (once), launches and counts its kernel, or raises.  Work runs on
the device its input tensors live on — nothing moves to the CPU quietly.

This package never imports ``jax``.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
