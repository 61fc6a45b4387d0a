"""Find a cell's configuration, traffic mix, generator and metric
readers by the names ``BENCHMARK.json`` gives.

Each lives in a file of its own under one of the search roots (the
``stackbench`` folder first of all): ``configs/<config>.json``,
``traffic/<mix>.json`` (whose ``generator`` names
``traffic/<generator>.py``) and ``metrics/<metric>.py``.  So a cell, a
configuration, a mix or a metric is added by adding files and entries,
and no file that is already there changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


class Registry:
    def __init__(self, benchmark: dict, roots=(HERE,)):
        self.benchmark = benchmark
        self.roots = [Path(r) for r in roots]
        self._modules = {}

    @classmethod
    def load(cls, path=BENCHMARK, roots=(HERE,)) -> "Registry":
        return cls(json.loads(Path(path).read_text()), roots)

    def _find(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            path = root / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise KeyError(f"no {kind}/{name}{suffix} under "
                       f"{[str(r) for r in self.roots]}")

    def cell(self, name: str) -> dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads(self._find("configs", name, ".json").read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(self._find("traffic", name, ".json").read_text())

    def _module(self, kind: str, name: str):
        path = self._find(kind, name, ".py")
        if path not in self._modules:
            tag = "".join(c if c.isalnum() else "_" for c in name)
            spec = importlib.util.spec_from_file_location(
                f"stackbench_{kind}_{tag}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def generator(self, name: str):
        return self._module("traffic", name)

    def reader(self, metric: str):
        return self._module("metrics", metric)

    def metrics(self, kind: str, cell: str) -> list:
        """The ``kind`` ('end_to_end' or 'per_layer') metrics that ``cell``
        reports: those that list it, and those that list no cells."""
        return [m for m in self.benchmark[kind]
                if cell in m.get("workloads", [cell])]
