"""astrophotography_tpu_torch — the PyTorch + CUDA port of astrophotography_tpu.

The JAX package (``astrophotography_tpu``) stays the reference; this
package re-implements its stacking paths, lean and unfused
(calibrate -> detect -> register -> warp -> sigma-clip stack), on
PyTorch tensors, with the JAX package's three TPU Pallas kernels
rewritten as hand-written CUDA C++ kernels for Hopper (``csrc/``).

Modules:

* ``models/``: ``PipelineConfig`` and the two pipelines
  (``calibrate_register_stack_lean``, ``calibrate_register_stack``);
* ``ops/``: ``stats``, ``calibrate`` and ``badpix`` (bad-pixel masks and
  repair), ``detect`` (``find_stars``, ``find_saturated``,
  ``mask_boxes``), ``detect_tiles`` (kernel K1), ``register``, ``warp``,
  ``warp_combine`` (kernel K2), ``stack`` and ``clip_combine`` (kernel
  K3), ``stencil``, ``imarith``, ``photometry``, ``psf``,
  ``background``, ``cosmic`` (L.A.Cosmic) and ``composite``;
* ``parallel/``: ``banded_warp_combine``, K2 over row bands on one device;
* ``kernels`` (build, bind, launch, count) and ``device``.

Every kernel has a plain PyTorch twin beside it.  A wrapper runs the
plain version only for tensors that live on the CPU; for CUDA tensors it
builds (once), launches and counts its kernel, or raises.  Work runs on
the device its input tensors live on — nothing moves to the CPU quietly.

This package never imports ``jax``.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
