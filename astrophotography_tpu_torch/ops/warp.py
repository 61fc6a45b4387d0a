"""Lanczos3 weights as a polynomial in t² (the JAX package's
``ops/warp.py:_L3_POLY``).

The warp+combine kernel and its plain twin evaluate every tap weight
with this degree-10 polynomial, never with ``sinc``, so the port's
weights are the reference's to float32 rounding.
"""

from __future__ import annotations

import torch

#: minimax-style polynomial of lanczos3(t) in u = t^2 on [0, 9]
#: (max abs error 2.8e-6)
_L3_POLY = (
    9.999994525888e-01,
    -1.827688926461e+00,
    1.122335944632e+00,
    -3.557261514981e-01,
    6.945395735140e-02,
    -9.185528553885e-03,
    8.680491817837e-04,
    -5.970731138175e-05,
    2.910034981863e-06,
    -9.078439824764e-08,
    1.359070044584e-09,
)


def lanczos3_poly(t: torch.Tensor) -> torch.Tensor:
    """lanczos3 weight via the polynomial in t^2 (zero for |t| >= 3)."""
    u = t * t
    acc = torch.full_like(u, _L3_POLY[-1])
    for c in _L3_POLY[-2::-1]:
        acc = acc * u + c
    return torch.where(u < 9.0, acc, 0.0)
