"""Halo exchange for spatially-sharded stencil computations (the JAX
package's ``parallel/halo.py``).

When an image's rows are sharded over the 'space' axis of a mesh,
stencil ops (neighbourhood medians, Laplacians, the warp's vertical
taps) need each shard to see a few rows of its neighbours.  Each rank
sends its first and last ``halo`` rows to the ranks above and below it
on the axis (``dist.batch_isend_irecv``, to the real neighbours only),
pads its block with what it receives, and zero rows at the global
edges: the JAX ring's result, whose wrap-around is masked to zero.
Under the gloo transport the rows of a CUDA block go through pinned host
buffers (``parallel/mesh``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import FrameSpaceMesh, _Exchange, _from_wire, _nbytes, _wire


def halo_exchange_rows(block: torch.Tensor, halo: int, mesh: FrameSpaceMesh,
                       axis_name: str = "space") -> torch.Tensor:
    """Pad a row-sharded (..., H_local, W) block with ``halo`` rows from
    each neighbour on ``axis_name`` (zero rows at the global edges).
    Returns (..., H_local + 2 * halo, W) on the block's device."""
    if not 0 < halo <= block.shape[-2]:
        raise ValueError(f"halo {halo} must be in [1, {block.shape[-2]}] "
                         f"(the local block's rows)")
    n = mesh.size(axis_name)
    idx = mesh.index(axis_name)
    src = _wire(block.contiguous())
    edge = src.shape[:-2] + (halo, src.shape[-1])
    from_prev = torch.zeros(edge, dtype=src.dtype, device=src.device)
    from_next = torch.zeros(edge, dtype=src.dtype, device=src.device)
    if n > 1:
        ranks = mesh.axis_ranks(axis_name)
        group = mesh.group(axis_name)
        ex = _Exchange(mesh, "halo", axis_name, block.device)
        # rows this shard sends upward / downward
        top, bot = ex.out(src[..., :halo, :].contiguous(),
                          src[..., -halo:, :].contiguous())
        ops, recv = [], []
        if idx > 0:
            buf = ex.buffer(edge, src.dtype)
            ops += [dist.P2POp(dist.isend, top, ranks[idx - 1], group),
                    dist.P2POp(dist.irecv, buf, ranks[idx - 1], group)]
            recv.append(("prev", buf))
        if idx < n - 1:
            buf = ex.buffer(edge, src.dtype)
            ops += [dist.P2POp(dist.isend, bot, ranks[idx + 1], group),
                    dist.P2POp(dist.irecv, buf, ranks[idx + 1], group)]
            recv.append(("next", buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        got = dict(zip((side for side, _ in recv),
                       ex.back(*(buf for _, buf in recv))))
        from_prev = got.get("prev", from_prev)
        from_next = got.get("next", from_next)
        ex.done(len(recv) * _nbytes(top), len(recv) * _nbytes(top))
    out = torch.cat([from_prev, src, from_next], dim=-2)
    return _from_wire(out, block.dtype)


def sharded_map_overlap(
    fn: Callable[[torch.Tensor], torch.Tensor],
    mesh: FrameSpaceMesh,
    halo: int,
    axis_name: str = "space",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Lift a stencil function to row-sharded blocks with halo exchange.

    ``fn`` maps an (H_local + 2 * halo, W) padded block to a block of the
    same shape (a same-shape stencil, e.g. a convolution or a
    neighbourhood median); the returned function exchanges the halos of
    this rank's block, applies ``fn`` and crops the halo rows.  The
    result equals ``fn`` on the unsharded image wherever the stencil's
    radius is <= ``halo`` (zero-padded edges)."""

    def local(block: torch.Tensor) -> torch.Tensor:
        out = fn(halo_exchange_rows(block, halo, mesh, axis_name))
        return out[..., halo:out.shape[-2] - halo, :]

    return local
