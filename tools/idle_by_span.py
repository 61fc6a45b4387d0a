#!/usr/bin/env python3
"""Where a benchmark cell's card idles, by the program's own spans.

Runs the entry of a ``stackbench`` cell on its night (made on the card
from ``--seed``, as the benchmark makes it): two warm-up requests, then
``--requests`` requests under ``torch.profiler``, each inside the
benchmark's request range.  The trace goes through
``stackbench.tracing.reduce`` unchanged, with the program's span names
(``apt.*``, from ``utils.timing.records``).  Prints, per request:

* each program span's calls, device time (the operations launched inside
  it, its children's included), host self time (its host time less
  its children's) and the distinct attributes it carried (K2's
  ``route``, ``span`` and ``taps``);
* the card's idle time, by the innermost program span open on the host
  when each gap began;
* the traced request latency (median, ms; the image downloaded into a
  page-locked buffer) and the program's counters;
* then one request under ``torch.cuda.set_sync_debug_mode('warn')``:
  the synchronizations the card reports in one stack call (the image's
  download left out) against the ``host_reads`` the program counted in
  a traced one.

Run from the root of a checkout: ``PYTHONPATH=. python3
tools/idle_by_span.py --workload lean-rot-16mpix-n100.rotate``.  On a
checkout whose program keeps no span records it prints the latency and
the synchronizations alone.  The last line of standard output is the
JSON summary; ``--out`` writes it to a file too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
import warnings
from collections import defaultdict

import torch

from stackbench import tracing
from stackbench.registry import Registry
from stackbench.run import pipeline_config


def _records():
    try:
        from astrophotography_tpu_torch.utils.timing import records
    except ImportError:
        return None
    return records()


def _self_ms(recs) -> dict:
    """Host self time of each span name, summed, in ms."""
    child = defaultdict(int)
    for r in recs:
        if r["parent"] is not None:
            child[r["parent"]] += r["t1"] - r["t0"]
    out = defaultdict(float)
    for r in recs:
        out[r["name"]] += (r["t1"] - r["t0"] - child[r["id"]]) / 1e6
    return dict(out)


def _attrs(recs) -> dict:
    """The distinct attributes each span name carried (K2's route, span
    and taps; the entry), leaving out spans that carry none."""
    out = defaultdict(list)
    for r in recs:
        if r["attrs"] and r["attrs"] not in out[r["name"]]:
            out[r["name"]].append(r["attrs"])
    return dict(out)


def _syncs(call) -> int:
    """The synchronizations the card's sync debug mode reports in one
    ``call``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    reg = Registry.load()
    cell = reg.cell(args.workload)
    config = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    dev = torch.device("cuda")
    obs = reg.generator(mix["generator"]).inputs(config, mix, args.seed, dev)
    cfg = pipeline_config(config)
    from astrophotography_tpu_torch.models import pipeline

    entry = getattr(pipeline, config["entry"])

    def stack():
        return entry(obs.frames, bias=obs.bias, dark=obs.dark, flat=obs.flat,
                     exp_ratios=obs.exp_ratios, config=cfg)

    host = None

    def request():
        # the image into a page-locked buffer made once, as the benchmark
        # downloads it
        nonlocal host
        image = stack()[0]
        if host is None:
            host = torch.empty(image.shape, dtype=image.dtype,
                               pin_memory=image.is_cuda)
        host.copy_(image)

    for _ in range(2):
        request()
    torch.cuda.synchronize()
    before = {r["id"] for r in (_records() or [])}
    lat = []
    with tracing.profiler() as prof:
        for _ in range(args.requests):
            t0 = time.perf_counter()
            with torch.profiler.record_function(tracing.REQUEST):
                request()
            lat.append(time.perf_counter() - t0)
    recs = [r for r in (_records() or []) if r["id"] not in before]
    names = sorted({r["name"] for r in recs})
    tr = tracing.reduce(prof, names)
    n = tr.requests or 1
    out = {"workload": args.workload, "seed": args.seed,
           "requests": tr.requests,
           "traced_request_ms": statistics.median(lat) * 1e3,
           "window_s": tr.window_s, "busy_s": tr.busy_s,
           "device_ops_per_request": tr.device_ops / n,
           "idle_ms_per_request": {k: v * 1e3 / n for k, v in sorted(
               tr.idle_by_host.items(), key=lambda kv: -kv[1])}}
    if recs:
        self_ms = _self_ms(recs)
        attrs = _attrs(recs)
        out["spans"] = {name: {
            "calls": tr.span_calls.get(name, 0) / n,
            "device_ms": tr.span_device_s.get(name, 0.0) * 1e3 / n,
            "host_self_ms": self_ms.get(name, 0.0) / n,
            "attrs": attrs.get(name, [])} for name in names}
        counters = defaultdict(float)
        for r in recs:
            for k, v in r["counters"].items():
                counters[k] += v
        stacks = sum(1 for r in recs if r["name"] == "apt.stack") or 1
        out["counters_per_stack"] = {k: v / stacks
                                     for k, v in sorted(counters.items())}
    out["sync_warnings_per_stack"] = _syncs(stack)
    from astrophotography_tpu_torch.device import card_line

    out["card"] = card_line(0)
    for name, row in out.get("spans", {}).items():
        print(f"{name:<24} calls {row['calls']:5.1f}  device "
              f"{row['device_ms']:9.3f} ms  host self "
              f"{row['host_self_ms']:8.3f} ms"
              + "".join(f"  {a}" for a in row["attrs"]))
    for name, ms in out["idle_ms_per_request"].items():
        print(f"idle in {name:<24} {ms:8.3f} ms a request")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
