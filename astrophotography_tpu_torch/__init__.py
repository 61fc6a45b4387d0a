"""astrophotography_tpu_torch — the PyTorch + CUDA port of astrophotography_tpu.

The JAX package (``astrophotography_tpu``) stays the reference; this
package re-implements its stacking paths, lean and unfused
(calibrate -> detect -> register -> warp -> sigma-clip stack), on
PyTorch tensors, with the JAX package's three TPU Pallas kernels
rewritten as hand-written CUDA C++ kernels for Hopper (``csrc/``), and
its file layer with the first file-to-file tools: RAW conversion
(``dksraw``) and the calibration-file engines.

Modules:

* ``models/``: ``PipelineConfig`` and the two pipelines
  (``calibrate_register_stack_lean``, ``calibrate_register_stack``);
* ``ops/``: ``stats``, ``calibrate`` and ``badpix`` (bad-pixel masks and
  repair), ``detect`` (``find_stars``, ``find_saturated``,
  ``mask_boxes``), ``detect_tiles`` (kernel K1), ``register``, ``warp``,
  ``warp_combine`` (kernel K2), ``stack`` and ``clip_combine`` (kernel
  K3), ``stencil``, ``imarith``, ``photometry``, ``psf``,
  ``background``, ``cosmic`` (L.A.Cosmic), ``composite`` and
  ``demosaic`` (RAW -> RGB / grey);
* ``parallel/``: ``banded_warp_combine``, K2 over row bands on one
  device, and the host <-> device I/O pipeline (``PrefetchLoader``,
  ``stream_stacks``, ``AsyncWriter``);
* ``io/`` (FITS, RAW containers, lossless JPEG with its C++ half under
  ``native/``, 16-bit PNG, the output writer), ``synth`` and ``utils/``
  (logger, YAML config, timing): host code, the package's own copies;
* ``core/`` (``RawConv``, ``make_master``, ``calc_read_noise``,
  ``Calibrator``, the bad-pixel workflows), ``api/`` and ``cli/``
  (``dksraw`` and six ``ap_*`` tools, each with ``--device``);
* ``kernels`` (build, bind, launch, count) and ``device``.

Every kernel has a plain PyTorch twin beside it.  A wrapper runs the
plain version only for tensors that live on the CPU; for CUDA tensors it
builds (once), launches and counts its kernel, or raises.  Work runs on
the device its input tensors live on — nothing moves to the CPU quietly.
Entry points that start from files take ``device=None``, which means the
card (an error without one); the CPU is used only when asked for by name.

This package never imports ``jax``.
"""

from .__version__ import __version__

__all__ = ["__version__"]
