"""The (frame, space) mesh over the ranks of a process group, the
placement helpers and the one collective the pipelines need (the JAX
package's ``parallel/mesh.py``).

JAX builds a ``Mesh`` over its devices and lets XLA insert the
collectives.  Here every rank is a process (``parallel/launch.spawn``);
:func:`frame_space_mesh` gives the calling rank its coordinates on a
row-major (frame, space) grid of the ranks, with one process group per
axis, and every collective is written out.  The two axes:

* ``frame``: the stack axis; calibration, detection and warping are
  parallel over it;
* ``space``: image rows; used for the cross-frame combine, with a row
  halo for stencils (``parallel/halo``).

Placement: :func:`shard_frames`, :func:`shard_spatial`,
:func:`replicate` and :func:`local_frames` return this rank's block of a
full tensor on the mesh's device, as the JAX ``PartitionSpec``\\ s place
it.  :func:`all_gather` and :func:`gather_rows` assemble blocks again.

Transport: the process group's backend.  ``nccl`` moves CUDA tensors
card to card.  ``gloo`` carries host tensors only, so a CUDA tensor is
staged through a pinned host buffer (one non-blocking copy each way);
ranks that share one card must use it, since NCCL refuses two ranks on
one GPU.  Every exchange appends a record to :attr:`FrameSpaceMesh.traffic`:
bytes sent and received, host-clock ms and the staging part of it.  On a
CUDA device the clock starts after the stream's earlier work has
finished and ends when the exchanged data is on the device.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device


def mesh_shape(n: int, n_frame: Optional[int] = None,
               n_space: Optional[int] = None) -> Tuple[int, int]:
    """(n_frame, n_space) of a mesh over ``n`` ranks.  With neither given,
    every rank is on the frame axis (more frames than devices, frames
    cheap to shard, one exchange before the combine)."""
    if n_frame is None and n_space is None:
        n_frame, n_space = n, 1
    elif n_frame is None:
        n_frame = n // n_space
    elif n_space is None:
        n_space = n // n_frame
    if n_frame * n_space != n:
        raise ValueError(
            f"mesh {n_frame}x{n_space} does not match {n} devices")
    return n_frame, n_space


class FrameSpaceMesh:
    """The calling rank's place on a row-major (frame, space) grid of the
    process group's ranks: rank r sits at (r // n_space, r % n_space).

    ``group(axis)`` is the process group of the ranks that share this
    rank's coordinate on the other axis, ordered along ``axis``;
    ``transport`` is the default group's backend, ``device`` where this
    rank's blocks live."""

    def __init__(self, n_frame: int, n_space: int, device: torch.device):
        self.rank = dist.get_rank()
        self.shape = {"frame": n_frame, "space": n_space}
        self.coords = {"frame": self.rank // n_space,
                       "space": self.rank % n_space}
        self.device = device
        self.transport = dist.get_backend()
        self.traffic: List[dict] = []
        self._ranks: Dict[str, List[int]] = {}
        self._groups: Dict[str, dist.ProcessGroup] = {}
        # every rank creates every group, in the same order
        lines = {"space": [[f * n_space + s for s in range(n_space)]
                           for f in range(n_frame)],
                 "frame": [[f * n_space + s for f in range(n_frame)]
                           for s in range(n_space)]}
        for axis in ("space", "frame"):
            for ranks in lines[axis]:
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._ranks[axis], self._groups[axis] = ranks, group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> dist.ProcessGroup:
        return self._groups[axis]

    def axis_ranks(self, axis: str) -> List[int]:
        """Global ranks of this rank's group on ``axis``, in axis order."""
        return self._ranks[axis]


def frame_space_mesh(n_frame: Optional[int] = None,
                     n_space: Optional[int] = None,
                     device=None) -> FrameSpaceMesh:
    """(frame, space) mesh over the ranks of the initialised process
    group, with the JAX package's defaults and arithmetic
    (:func:`mesh_shape`).  ``device`` is where this rank's blocks go
    (CUDA when not given)."""
    n_frame, n_space = mesh_shape(dist.get_world_size(), n_frame, n_space)
    return FrameSpaceMesh(n_frame, n_space, resolve_device(device))


def _block(mesh: FrameSpaceMesh, x: torch.Tensor, dim: int, axis: str):
    size = x.shape[dim]
    n = mesh.size(axis)
    if size % n:
        what = "height" if axis == "space" else "frame count"
        raise ValueError(f"{what} {size} not divisible by {axis} axis {n}")
    k = size // n
    return x.narrow(dim, mesh.index(axis) * k, k)


def _place(mesh: FrameSpaceMesh, x: torch.Tensor) -> torch.Tensor:
    return x.to(mesh.device).contiguous()


def local_frames(mesh: FrameSpaceMesh, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) stack: frames over 'frame', every row (the pipelines'
    input, ``P("frame", None, None)``)."""
    return _place(mesh, _block(mesh, x, 0, "frame"))


def shard_frames(mesh: FrameSpaceMesh, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) stack: frames over 'frame', rows over 'space'
    (``P("frame", "space", None)``)."""
    return _place(mesh, _block(mesh, _block(mesh, x, 0, "frame"), -2,
                               "space"))


def shard_spatial(mesh: FrameSpaceMesh, x: torch.Tensor) -> torch.Tensor:
    """(..., H, W): rows over 'space', replicated over 'frame'
    (``P("space", None)`` for an image, ``P(None, "space", None)`` for a
    stack of planes)."""
    return _place(mesh, _block(mesh, x, -2, "space"))


def replicate(mesh: FrameSpaceMesh, x: torch.Tensor) -> torch.Tensor:
    """The whole tensor on every rank (``P()``)."""
    return _place(mesh, x)


# ---- exchanges ----------------------------------------------------------

def _wire(t: torch.Tensor) -> torch.Tensor:
    """A view of ``t`` that both transports carry: 16-bit integers go as
    their bytes (neither gloo nor NCCL has a 16-bit integer type)."""
    return t.view(torch.uint8) if t.dtype in (torch.uint16, torch.int16) \
        else t


def _from_wire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if t.dtype != dtype else t


class _Exchange:
    """Staging and the clock of one exchange on ``mesh``.

    ``out(t)`` gives the tensor to hand to the transport (a pinned host
    copy of a CUDA tensor under gloo), ``buffer(shape, dtype)`` one to
    receive into, ``back(t)`` the received tensor on the mesh's device;
    ``done(...)`` appends the traffic record."""

    def __init__(self, mesh: FrameSpaceMesh, op: str, axis: str,
                 dev: torch.device):
        self.mesh, self.op, self.axis, self.dev = mesh, op, axis, dev
        self.cuda = dev.type == "cuda"
        self.staged = self.cuda and mesh.transport == "gloo"
        self.staging_s = 0.0
        self._sync()
        self.t0 = time.perf_counter()

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.current_stream(self.dev).synchronize()

    def out(self, *tensors: torch.Tensor) -> List[torch.Tensor]:
        if not self.staged:
            return list(tensors)
        t = time.perf_counter()
        host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                .copy_(x, non_blocking=True) for x in tensors]
        self._sync()
        self.staging_s += time.perf_counter() - t
        return host

    def buffer(self, shape, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.dev)

    def back(self, *tensors: torch.Tensor) -> List[torch.Tensor]:
        t = time.perf_counter()
        if self.staged:
            tensors = tuple(x.to(self.dev, non_blocking=True)
                            for x in tensors)
        self._sync()
        if self.staged:
            self.staging_s += time.perf_counter() - t
        return list(tensors)

    def done(self, sent: int, received: int) -> None:
        self.mesh.traffic.append({
            "op": self.op, "axis": self.axis, "transport":
            self.mesh.transport, "bytes_sent": sent,
            "bytes_received": received,
            "ms": (time.perf_counter() - self.t0) * 1e3,
            "staging_ms": self.staging_s * 1e3})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather(mesh: FrameSpaceMesh, x: torch.Tensor,
               axis: str = "frame") -> torch.Tensor:
    """Every block of ``x`` along ``axis``, concatenated along dim 0 in
    axis order (frame-sharded stacks come back in global frame order,
    row bands in row order), on every rank of the axis."""
    n = mesh.size(axis)
    if n == 1:
        return x
    x = x.contiguous()
    ex = _Exchange(mesh, "all_gather", axis, x.device)
    (src,) = ex.out(_wire(x))
    out = ex.buffer((n,) + tuple(src.shape), src.dtype)
    dist.all_gather(list(out.unbind(0)), src, group=mesh.group(axis))
    (out,) = ex.back(out)
    ex.done(_nbytes(src), (n - 1) * _nbytes(src))
    out = out.reshape((n * src.shape[0],) + tuple(src.shape[1:]))
    return _from_wire(out, x.dtype)


def gather_rows(mesh: FrameSpaceMesh, local: torch.Tensor,
                axis: str = "space") -> torch.Tensor:
    """The whole (H, W) image on every rank from its row-sharded
    (H / n_space, W) blocks."""
    return all_gather(mesh, local, axis)
