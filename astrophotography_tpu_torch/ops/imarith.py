"""fimarith-style image arithmetic (the JAX package's ``ops/imarith.py``):
ADD / SUB / MUL / DIV of an image with a scalar or a second image, in
float32; a caller that writes files casts the result."""

from __future__ import annotations

from typing import Union

import torch

from ..device import numpy_inputs, to_float32

ALLOWED_OPS = ("ADD", "SUB", "MUL", "DIV")


@numpy_inputs("img", "value")
def imarith(img: torch.Tensor, op: str,
            value: Union[float, torch.Tensor]) -> torch.Tensor:
    op = op.upper()
    img = to_float32(img)
    value = to_float32(value) if isinstance(value, torch.Tensor) else \
        torch.as_tensor(value, dtype=torch.float32, device=img.device)
    if op == "ADD":
        return img + value
    if op == "SUB":
        return img - value
    if op == "MUL":
        return img * value
    if op == "DIV":
        return img / value
    raise ValueError(f"operation must be one of {ALLOWED_OPS}, got {op!r}")
