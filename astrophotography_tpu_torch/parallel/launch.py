"""Start the ranks of a multi-device run.

The JAX package gets its devices from XLA (a TPU slice, or virtual CPU
devices).  Here each device of a mesh is a process: :func:`spawn` starts
``world`` ranks with the ``spawn`` start method; each joins a process
group over a ``FileStore`` in a temporary directory (no network), puts
itself on its device and calls ``fn(device, *args)``.

Devices: ``'cpu'``, or ``'cuda'``: every rank on ``cuda:0`` when the
machine has one card, rank r on ``cuda:r`` (modulo the card count)
otherwise.  ``device=None`` means CUDA and raises without a card.

Transport, named by the caller: ``'nccl'`` moves CUDA tensors card to
card and needs one card per rank (NCCL refuses two ranks on one GPU), so
choosing it for ranks that share a card is an error raised before any
rank starts; ``'gloo'`` moves host tensors, and the exchanges of
``parallel/mesh`` and ``parallel/halo`` stage a CUDA tensor through a
pinned host buffer.  Nothing switches transport on its own.

Inputs: CPU tensors in ``args`` (top level, or values of a dict, list or
tuple there) are moved to shared memory, so every rank reads the same
pages and no rank builds the workload again; CUDA tensors are refused.
Results: each rank's return value is saved to the temporary directory
(tensors come back on the CPU); :func:`spawn` returns them in rank
order.  A rank that raises or dies makes :func:`spawn` stop the others
and raise with that rank's traceback.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Callable, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device

TRANSPORTS = ("gloo", "nccl")
#: seconds a collective may wait for a peer before the rank raises
PG_TIMEOUT_S = 900
#: seconds :func:`spawn` waits for its ranks
SPAWN_TIMEOUT_S = 1800


def rank_devices(device, world: int) -> List[torch.device]:
    """The device of each of ``world`` ranks (see the module docstring)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * world
    if dev.type != "cuda" or dev.index is not None:
        raise ValueError(f"ranks run on 'cpu' or 'cuda', not {dev}")
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(world)]


def default_transport(device, world: int) -> str:
    """'nccl' when every rank has a card of its own, else 'gloo'."""
    devs = rank_devices(device, world)
    own_card = devs[0].type == "cuda" and len(set(devs)) == world
    return "nccl" if own_card else "gloo"


def check_transport(devices: List[torch.device], transport: str) -> None:
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, "
                         f"got {transport!r}")
    if transport != "nccl":
        return
    if devices[0].type != "cuda":
        raise ValueError("transport 'nccl' needs CUDA devices")
    if len(set(devices)) < len(devices):
        raise ValueError(
            f"transport 'nccl' needs one card per rank: {len(devices)} "
            f"ranks share {len(set(devices))} card(s); use 'gloo' "
            f"(host-staged)")


def _share(x):
    """``x`` with every CPU tensor in shared memory (in place)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("spawn passes CPU tensors only; each rank "
                             "moves its own block to its device")
        return x.share_memory_()
    if isinstance(x, dict):
        return {k: _share(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_share(v) for v in x)
    return x


def _rank_main(fn, rank: int, world: int, device: str, transport: str,
               tmp: str, args: tuple) -> None:
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        transport, store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        result = fn(dev, *args)
        torch.save(result, os.path.join(tmp, f"result{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _failure(procs, tmp: str) -> str:
    """Every rank's traceback, and the exit code of each rank that died
    without one.  A rank writes its traceback before it leaves the
    process group, so the rank that failed first is listed even when a
    peer's collective failed (and exited) before it."""
    lines = []
    for r, p in enumerate(procs):
        path = os.path.join(tmp, f"error{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                lines.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode not in (None, 0):
            lines.append(f"rank {r}:\nexit code {p.exitcode}, no "
                         f"traceback\n")
    return "\n".join(lines)


def spawn(fn: Callable, world: int, *, device=None, transport: str,
          args: tuple = ()) -> list:
    """Run ``fn(device, *args)`` on ``world`` ranks and return every
    rank's result, in rank order.

    ``fn`` must be importable (a module-level function).  Raises
    ``ValueError`` before starting anything for a transport the devices
    cannot use, ``RuntimeError`` with the failing ranks' tracebacks when
    a rank raises or dies, ``TimeoutError`` after
    :data:`SPAWN_TIMEOUT_S`."""
    devices = rank_devices(device, world)
    check_transport(devices, transport)
    args = _share(tuple(args))
    if devices[0].type == "cuda":
        # build the kernels once here, not in every rank at once
        from .. import kernels

        kernels.build()
    tmp = tempfile.mkdtemp(prefix="aptorch_ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, str(devices[r]), transport, tmp,
                               args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        running = list(procs)
        while running:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{SPAWN_TIMEOUT_S} s")
            wait([p.sentinel for p in running], timeout=left)
            for p in [p for p in running if p.exitcode is not None]:
                p.join()
                running.remove(p)
                if p.exitcode != 0:
                    # give the other ranks a moment to report their own
                    # failures, then stop them
                    wait([q.sentinel for q in running], timeout=2.0)
                    raise RuntimeError("a rank failed:\n"
                                       + _failure(procs, tmp))
        results = [torch.load(os.path.join(tmp, f"result{r}.pt"),
                              map_location="cpu", weights_only=False)
                   for r in range(world)]
    finally:
        for p in procs:
            if p.pid is None:           # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return results
