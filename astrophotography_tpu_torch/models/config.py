"""Pipeline configuration and the converters between the JAX package's
state and the port's.

:class:`PipelineConfig` is a jax-free copy of
``astrophotography_tpu.models.pipeline.PipelineConfig``: the same
fields, defaults and validation, so one configuration drives both
implementations.  This system has no weights; besides the configuration
its state is numpy arrays (frames, masters, exposure ratios, matrices)
that both sides take as they are.  :func:`from_jax_config` carries a JAX
configuration across, and :func:`stars_to_numpy` /
:func:`similarity_to_numpy` bring the port's diagnostics back to numpy
for comparison.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of the stacking pipeline (see the JAX
    package's ``PipelineConfig`` for each field's meaning; the lean path
    reads the detection, registration and warp+combine fields).
    ``combine_impl`` keeps the JAX package's three values, but 'xla' and
    'pallas' run one path here: both combine a band's 'average' with the
    K3 kernel (``models.pipeline.combine_band``)."""

    fwhm: float = 3.0
    detect_nsigma: float = 7.0
    max_stars: int = 64
    match_k: int = 12
    sigma_lower: float = 5.0
    sigma_upper: float = 5.0
    combine: str = "average"
    combine_impl: str = "xla"
    interp: str = "separable"
    warp_span: int = 12
    general_taps: str = "exact"
    dark_still_biased: bool = True
    n_bands: int = 1
    detect_mode: str = "vmap"
    detect_chunk: int = 8
    detect_topk: str = "global"
    ref_frame: "int | str" = 0
    detect_fast: bool = False
    detect_bin_rows: bool = False
    fused_tile: "tuple | None" = None
    noise_center: str = "mean"
    detect_impl: str = "auto"
    fused_apron: bool = True
    centroid: str = "com"
    dither_budget: int = 64

    def __post_init__(self):
        # catch typos up front: a misspelled mode would otherwise fall
        # through to a default path silently
        if self.centroid not in ("com", "kernel"):
            raise ValueError(f"PipelineConfig.centroid must be 'com' or "
                             f"'kernel', got {self.centroid!r}")
        if self.detect_impl not in ("auto", "chunked", "fused"):
            raise ValueError(f"PipelineConfig.detect_impl must be 'auto', "
                             f"'chunked' or 'fused', got {self.detect_impl!r}")
        if self.noise_center not in ("mean", "median"):
            raise ValueError(f"PipelineConfig.noise_center must be 'mean' "
                             f"or 'median', got {self.noise_center!r}")
        if self.general_taps not in ("exact", "lowrank"):
            raise ValueError(f"PipelineConfig.general_taps must be 'exact' "
                             f"or 'lowrank', got {self.general_taps!r}")


def from_jax_config(cfg) -> PipelineConfig:
    """The port's :class:`PipelineConfig` equal to a JAX package
    ``PipelineConfig`` (read field by field, so this module needs no
    JAX import).  Raises if the two classes' fields have drifted."""
    ours = {f.name for f in dataclasses.fields(PipelineConfig)}
    theirs = {f.name for f in dataclasses.fields(cfg)}
    if ours != theirs:
        raise ValueError(f"PipelineConfig fields differ: port-only "
                         f"{sorted(ours - theirs)}, JAX-only "
                         f"{sorted(theirs - ours)}")
    return PipelineConfig(**{name: getattr(cfg, name) for name in ours})


def _numpy(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def stars_to_numpy(stars) -> dict:
    """A ``Stars`` table (either package's) as a dict of numpy arrays."""
    return {name: _numpy(getattr(stars, name)) for name in stars._fields}


def similarity_to_numpy(sim) -> dict:
    """A ``Similarity`` (either package's) as a dict of numpy arrays."""
    return {name: _numpy(getattr(sim, name)) for name in sim._fields}
