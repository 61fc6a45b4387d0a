"""Run one cell of the benchmark once and print its result line.

    python3 -m stackbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  Set-up: the program's kernels loaded (built in a
checkout's first run), the cell's observation made on the card from
``--seed``, two warm-up requests.  Window: the traffic's generator
drives whole stack requests for ``--seconds``.  Then the program's state
is freed; every request's registration is judged against the true
maps, and the plain reference (``stackbench/reference``) judges a
seeded sample of the window's images.  With ``--trace 1`` the window
runs under ``torch.profiler``, with spans around the configuration's
layers, and the line carries the per-layer metrics.

The last lines of standard error, and the ``checks`` key that closes the
result line, give each number compared with its limit.  The last line of
standard output is the JSON result.  Exits non-zero, with no result,
without the cards the cell asks for, or when JAX or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse                                             # noqa: E402
import contextlib                                           # noqa: E402
import json                                                 # noqa: E402
import os                                                   # noqa: E402
import random                                               # noqa: E402
import sys                                                  # noqa: E402
from dataclasses import dataclass                           # noqa: E402
from pathlib import Path                                    # noqa: E402

import numpy as np                                          # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "astrophotography_tpu")
#: a frame whose solve matched fewer distinct stars is unregistered (the
#: registration's own rule: it rejects such a solve)
MIN_INLIERS = 2
#: a rejected solve's translation (the registration's marker, 1e9 px);
#: no frame of a night moves this far
REJECTED_PX = 1e8


def fixed_caches(root: Path = ROOT) -> None:
    """Point every build and kernel cache the program could use at fixed
    directories inside the checkout (the program's own kernels build
    under ``build/torch_kernels`` there already)."""
    base = root / "build" / "stackbench"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda")


@dataclass
class Window:
    latencies_s: list
    completed: int
    failed: int
    window_s: float
    setup_s: float
    peak_bytes: int


@dataclass
class Context:
    """What a metric reader gets."""

    cell: dict
    config: dict
    mix: dict
    window: Window
    trace: object = None

    @property
    def n(self):
        return self.config["frames"]

    @property
    def h(self):
        return self.config["height"]

    @property
    def w(self):
        return self.config["width"]

    @property
    def pixels(self):
        return self.n * self.h * self.w

    @property
    def pipeline(self):
        return self.config["pipeline"]


class Sample:
    """A reservoir of ``k`` images drawn from the seed, held in ``k + 1``
    host buffers made once (page-locked on a card): a request downloads
    into the spare one, and :meth:`offer` swaps it into the reservoir or
    leaves it spare, so nothing is allocated or copied on the host inside
    the window."""

    def __init__(self, k: int, seed: int, pin: bool):
        self.k, self.seed, self.pin = k, seed, pin
        self.spare, self.free, self.kept = None, [], []
        self.reset()

    def reset(self) -> None:
        """Empty the reservoir (its buffers kept) and restart its draw."""
        self.free += self.kept
        self.kept, self.seen = [], 0
        self.rng = random.Random(self.seed)

    def buffer(self, like):
        """The spare host buffer, of ``like``'s shape and type."""
        if self.spare is None:
            import torch

            self.free = [torch.empty(like.shape, dtype=like.dtype,
                                     pin_memory=self.pin)
                         for _ in range(self.k)]
            self.spare = torch.empty(like.shape, dtype=like.dtype,
                                     pin_memory=self.pin)
        return self.spare

    def offer(self) -> None:
        """Offer the image in the spare buffer."""
        item = self.spare
        if len(self.kept) < self.k:
            self.kept.append(item)
            self.spare = self.free.pop()
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.spare, self.kept[j] = self.kept[j], item
        self.seen += 1


def pipeline_config(config: dict):
    from astrophotography_tpu_torch.models import PipelineConfig

    kw = dict(config["pipeline"])
    if kw.get("fused_tile") is not None:
        kw["fused_tile"] = tuple(kw["fused_tile"])
    return PipelineConfig(**kw)


#: the diagnostics a request brings back to the host, in one copy
DIAG_KEYS = ("n_inliers", "tx", "ty", "scale", "theta", "matrices")


def pack(finite, diag):
    """(keys, one float64 host array): the image's finiteness and the
    registration the entry reports, copied from the card at once."""
    import torch

    keys = [k for k in DIAG_KEYS if k in diag]
    flat = torch.cat([finite.reshape(1).to(torch.float64)]
                     + [diag[k].reshape(-1).to(torch.float64)
                        for k in keys])
    return keys, flat.cpu().numpy()


def unpack(keys, flat, n: int) -> dict:
    out, at = {"finite": bool(flat[0])}, 1
    for k in keys:
        size = 6 * n if k == "matrices" else n
        out[k] = flat[at:at + size]
        at += size
    if "matrices" in out:
        out["matrices"] = out["matrices"].reshape(n, 2, 3)
    return out


def registered(solved: dict) -> bool:
    """Every frame's solve was accepted: enough matched stars and no
    rejected-translation marker."""
    return bool((solved["n_inliers"] >= MIN_INLIERS).all()) and bool(
        (np.abs(solved["tx"]) < REJECTED_PX).all())


def solved_maps(solved: dict) -> np.ndarray:
    """(N, 2, 3) reference -> frame maps the entry reports: the matrices
    it stacked by, where it returns them, else its similarities'."""
    from stackbench.reference.stack import maps_of

    return solved["matrices"] if "matrices" in solved else maps_of(solved)


def _peak(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def run_cell(reg, name: str, seed: int, seconds: float, trace: bool,
             device="cuda") -> dict:
    """One run of cell ``name``: its result dict (without the device's
    name and count, which :func:`main` adds)."""
    import torch

    from astrophotography_tpu_torch.models import pipeline as pl
    from stackbench import tracing
    from stackbench.reference.stack import (corner_errors, gaps,
                                            reference_stack)

    cell = reg.cell(name)
    config = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    gen = reg.generator(mix["generator"])
    dev = torch.device(device)
    cfg = pipeline_config(config)
    obs = gen.inputs(config, mix, seed, dev)
    n, h, w = obs.frames.shape
    entry = getattr(pl, config["entry"])
    sample = Sample(int(mix["sample_images"]), seed, dev.type == "cuda")
    answers = []
    span = torch.profiler.record_function if trace else \
        (lambda _name: contextlib.nullcontext())

    def request(_i):
        with span(tracing.REQUEST):
            image, diag = entry(obs.frames, bias=obs.bias, dark=obs.dark,
                                flat=obs.flat, exp_ratios=obs.exp_ratios,
                                config=cfg)
            finite = torch.isfinite(image).all()
            with span(tracing.DOWNLOAD):
                sample.buffer(image).copy_(image)
                keys, flat = pack(finite, diag)
        solved = unpack(keys, flat, n)
        good = solved["finite"] and registered(solved)
        if good:
            sample.offer()
            answers.append(solved)
        return good

    spans = tracing.Spans(pl.__name__, config["spans"] if trace else ())
    prof = tracing.profiler() if trace else contextlib.nullcontext()
    with spans:
        for i in range(2):                          # warm-up
            if not request(-1 - i):
                raise RuntimeError(f"warm-up request {i} failed: a frame's "
                                   f"solve was rejected or the image is "
                                   f"not finite")
        sample.reset()
        answers.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - T0
        with prof:
            lat, ok, window_s = gen.drive(request, seconds)
        window_peak = _peak(dev)
    summary = tracing.reduce(prof, config["spans"]) if trace else None
    failed = ok.count(False)
    window = Window(latencies_s=[t if good else window_s
                                 for t, good in zip(lat, ok)],
                    completed=len(lat) - failed, failed=failed,
                    window_s=window_s, setup_s=setup_s,
                    peak_bytes=window_peak)
    ctx = Context(cell, config, mix, window, summary)
    del prof, request
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: every answer's registration against the true maps, then
    # the reference and each sampled image against it
    numbers = {}
    if answers:
        numbers["reg_corner_px"] = max(
            float(corner_errors(solved_maps(a), obs.matrices, h, w).max())
            for a in answers)
    ref, compared = reference_stack(obs, {
        "method": cfg.combine, "sigma_lower": cfg.sigma_lower,
        "sigma_upper": cfg.sigma_upper})
    for image in sample.kept:
        for key, val in gaps(image, ref, compared).items():
            numbers[key] = max(numbers.get(key, 0.0), val)
    del ref, compared, obs
    limits = config["limits"]
    checks = {"failed_requests": {"value": failed, "limit": 0}}
    for key, limit in limits.items():
        checks[key] = {"value": numbers.get(key), "limit": limit}
    correct = (len(lat) > 0 and failed == 0 and bool(sample.kept)
               and all(c["value"] is not None and c["limit"] is not None
                       and c["value"] <= c["limit"]
                       for c in checks.values()))

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in reg.metrics(kind, name):
        val = reg.reader(m["name"]).read(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(lat), "failed": failed,
              "metrics": metrics,
              "device": {"memory_peak_bytes": window_peak}}
    if trace:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
        result["trace"] = {"requests": summary.requests,
                           "device_ops": summary.device_ops,
                           "unlinked_ops": summary.unlinked_ops,
                           "span_device_s": summary.span_device_s}
    result["readings"] = numbers
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches()

    from stackbench.registry import Registry

    reg = Registry.load()
    cell = reg.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"stackbench: cell {args.workload} needs {cell['chips']} "
              f"CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(reg, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"stackbench: the run loaded {found}", file=sys.stderr)
        return 3
    from astrophotography_tpu_torch.device import card_line

    checks = result.pop("checks")
    readings = result.pop("readings")
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell["chips"], **result["device"]}
    result["card"] = card_line(0)
    result["checks"] = checks
    for key, val in readings.items():
        if key not in checks:
            print(f"reading {key}: {val} (not compared)", file=sys.stderr)
    for key, c in checks.items():
        print(f"check {key}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
