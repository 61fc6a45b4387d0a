#!/usr/bin/env python3
"""Whether the unfused pipeline's registration depends on how many frames
are detected at once.

chip_smoke.py's 24-frame snap workload at 4096^2 (the unfused cell's
input) is calibrated, then its per-frame noise statistics, Stars tables
(``unfused_config()``) and solved matrices are computed on all 24 frames
at once and on two halves of 12 (what each frame shard of a 2x2 mesh
does), twice: with the statistics' sums as one reduction call over the
rows (``Tensor.sum(dim=1)``) and as the pipeline's folded sums
(``models.pipeline._row_sums``).  On the card a reduction's block shape
follows the number of rows, so the first may differ between the two
splits; the second adds the same pairs whatever the batch.

Run from the repository root: ``PYTHONPATH=. python3 tools/noise_sum_split.py``
(``--device cpu`` runs it on the host).  Prints one JSON line per sum
(the largest difference and the number of differing values of each
quantity, whole against halves), then the card's nvidia-smi line.
"""

import argparse
import json
import subprocess

import torch

import chip_smoke
from astrophotography_tpu_torch.models import pipeline
from astrophotography_tpu_torch.ops.calibrate import calibrate_batch


def _diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.double() - b.double()).abs()
    return {"max_abs": float(d.max()), "differing": int((d > 0).sum()),
            "of": d.numel()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    n = chip_smoke.UNFUSED_FRAMES
    frames, bias, dark, flat, er, _off, _mats = chip_smoke.make_workload(
        n, chip_smoke.SIZE)
    cfg = chip_smoke.unfused_config()
    b, d, f = (torch.from_numpy(x).to(dev) for x in (bias, dark, flat))
    cal = calibrate_batch(torch.from_numpy(frames).to(dev), b, d, f,
                          torch.full((n,), er, device=dev),
                          dark_still_biased=cfg.dark_still_biased)
    halves = (cal[:n // 2], cal[n // 2:])
    folded = pipeline._row_sums
    for name, sums in (("Tensor.sum", lambda x: x.sum(dim=1)),
                       ("_row_sums", folded)):
        pipeline._row_sums = sums
        try:
            whole = pipeline.frame_noise_stats(cal, cfg.noise_center)
            split = [pipeline.frame_noise_stats(h, cfg.noise_center)
                     for h in halves]
            st_w, _s, m_w, _r = pipeline.register_frames(cal, cfg)
            parts = [pipeline.detect_calibrated(h, cfg) for h in halves]
            st_s = pipeline._concat_stars(parts)
            _s, m_s, _r = pipeline._solve_frame_similarities(st_s, n, cfg)
        finally:
            pipeline._row_sums = folded
        res = {"sums": name, "frames": n, "split": [n // 2, n // 2],
               "device": str(dev),
               "center": _diff(whole[0], torch.cat([s[0] for s in split])),
               "std": _diff(whole[1], torch.cat([s[1] for s in split])),
               "stars_x": _diff(st_w.x, st_s.x),
               "stars_y": _diff(st_w.y, st_s.y),
               "matrices": _diff(m_w, m_s)}
        print(json.dumps(res), flush=True)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
