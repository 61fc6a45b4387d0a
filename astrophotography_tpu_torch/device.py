"""Device handling: work runs where its input tensors live.

The port never falls back to the CPU on its own.  A caller that asks for
``cuda`` on a machine without a usable card gets an error, and every
entry point takes its device from the tensors it is given.
"""

from __future__ import annotations

import functools
import inspect
from typing import Optional

import numpy as np
import torch

from .utils.timing import count, host_read


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device to put new tensors on: ``device`` if given, else CUDA.
    Raises when that is CUDA and no card is usable; the CPU is used only
    when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    return dev


def native_contiguous(x) -> np.ndarray:
    """``x`` as a C-contiguous numpy array in the machine's byte order.
    FITS data is big-endian on disk and ``torch.from_numpy`` refuses an
    array whose byte order is not native."""
    arr = np.ascontiguousarray(x)
    if not arr.dtype.isnative:
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr


def on_device(x, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
    """``x`` (tensor, numpy array or None) as a tensor on ``device``.

    A tensor already on another device is an error, not a silent copy:
    the main path's inputs must agree on where the work runs."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"tensor on {x.device}, expected {device}")
        return x if dtype is None else x.to(dtype)
    t = torch.from_numpy(native_contiguous(x))
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type == "cpu":
        return t
    count("h2d_bytes", t.numel() * t.element_size())
    with host_read(device):            # a copy from pageable host memory
        return t.to(device)


def _from_numpy(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, in the type ``jnp.asarray``
    gives it (float64 becomes float32); uint16 crosses as an int16 view,
    for the reason :func:`to_float32` gives."""
    arr = native_contiguous(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).to(device) \
            .view(torch.uint16)
    return torch.from_numpy(arr).to(device)


def numpy_inputs(*names: str):
    """Decorator of an op whose arguments ``names`` may be numpy arrays,
    as the JAX package's ops take them.  Each is converted once, at the
    op's entry, to a tensor on the device the call's tensors are on (all
    of them must agree); where the call gives no tensor, on the op's
    ``device`` argument if it has one, else on ``resolve_device(None)``:
    the card, and without one the ``RuntimeError`` that names it.  A
    numpy input is never put on the CPU unless the caller's tensors or
    ``device`` are there."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def op(*args, **kwargs):
            if not any(isinstance(v, np.ndarray)
                       for v in (*args, *kwargs.values())):
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            given = bound.arguments
            devices = {v.device for v in given.values()
                       if isinstance(v, torch.Tensor)}
            if len(devices) > 1:
                raise ValueError(f"{fn.__name__}: tensors on "
                                 f"{sorted(map(str, devices))}")
            dev = devices.pop() if devices else resolve_device(
                given.get("device"))
            for k in names:
                if isinstance(given.get(k), np.ndarray):
                    given[k] = _from_numpy(given[k], dev)
            return fn(*bound.args, **bound.kwargs)
        return op
    return wrap


def to_uint16(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float, any shape) clipped to [0, 65535], truncated and
    returned as uint16.  The cast goes through int32 and an int16 view,
    for the same reason as :func:`to_float32`."""
    i = x.clamp(0, 65535).to(torch.int32)
    return torch.where(i >= 32768, i - 65536, i).to(torch.int16) \
        .view(torch.uint16)


def to_float32(x: torch.Tensor) -> torch.Tensor:
    """float32 copy of ``x``.  uint16 goes through an int16 view, since
    uint16 arithmetic and casts are only partly implemented for CUDA
    tensors."""
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int32).bitwise_and_(0xFFFF) \
            .to(torch.float32)
    return x.to(torch.float32)


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU), so a
    host-clock stage ends when its device work does."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line(index: int = 0) -> str:
    """Card ``index``'s name and power limit as nvidia-smi reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``)."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[index]


def device_info(device: torch.device) -> dict:
    """``{"name", "power_limit_w", "count"}`` of the device a measurement
    ran on: a card's name from torch and its power limit from nvidia-smi,
    or ``name`` "cpu" with no power limit."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "count": 1}
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    limit = card_line(index).rsplit(",", 1)[1].split()[0]
    return {"name": torch.cuda.get_device_name(index),
            "power_limit_w": float(limit),
            "count": torch.cuda.device_count()}
