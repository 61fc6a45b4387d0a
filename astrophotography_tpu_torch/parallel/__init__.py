"""Multi-device scale-out on ``torch.distributed``, the row-band loop on
one device, and the host <-> device I/O pipeline (the JAX package's
``parallel/``).

* ``launch``: :func:`spawn` starts the ranks (one process per device of
  the mesh) with an explicit transport, gloo (host-staged) or NCCL;
* ``mesh``: the (frame, space) mesh of the ranks and the placement
  helpers (``frame_space_mesh``, ``shard_frames``, ``shard_spatial``,
  ``replicate``, ``local_frames``, ``all_gather``, ``gather_rows``);
* ``halo``: row halo exchange for stencils (``halo_exchange_rows``,
  ``sharded_map_overlap``);
* ``fused``: the fused warp+combine kernel over row bands, one device
  (``banded_warp_combine``) or one band per rank
  (``sharded_warp_combine``);
* ``sharded``: both pipelines on a mesh, every collective written out;
* ``pipeline``: ``PrefetchLoader``, ``stream_stacks``, ``AsyncWriter``.
"""

from .mesh import (
    frame_space_mesh,
    shard_frames,
    shard_spatial,
    replicate,
)
from .halo import halo_exchange_rows, sharded_map_overlap
from .fused import banded_warp_combine, sharded_warp_combine
from .pipeline import AsyncWriter, PrefetchLoader, stream_stacks

__all__ = [
    "sharded_warp_combine",
    "frame_space_mesh",
    "shard_frames",
    "shard_spatial",
    "replicate",
    "halo_exchange_rows",
    "sharded_map_overlap",
    "AsyncWriter",
    "PrefetchLoader",
    "stream_stacks",
    "banded_warp_combine",
]
