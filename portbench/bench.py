"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
a checkout, and under ``portbench/`` a file for each configuration (named
in ``BENCHMARK.json``), traffic mix (``traffic/<name>.json``), cell's
limits (``limits/<workload>.json``) and metric (``metrics/<name>.py``,
whose ``read(run)`` returns the number or None).  A configuration's keys
say what the system builds (``system.py``): a ``sensor`` (the learned
detector), ``dense_families`` with ``dense_rides_with`` (dense feature
maps and the one-hot family each rides with) and the ``backbone`` that
feeds them; without them, ground-truth classes into one-hot maps.  A
cell or a metric is added by adding files and entries: nothing here
names one."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List


class Bench:
    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, "portbench")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _json(self, *parts) -> Dict:
        with open(os.path.join(*parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return self._json(self.root, c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return self._json(self.dir, "traffic", f"{name}.json")

    def limits(self, workload: str) -> Dict[str, float]:
        return self._json(self.dir, "limits", f"{workload}.json")

    def metrics(self, workload: str, traced: bool) -> List[Dict]:
        """The cell's end-to-end metrics, or with ``traced`` its per-layer
        ones."""
        entries = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in entries
                if workload in m.get("workloads", [workload])]

    def reader(self, name: str) -> Callable:
        path = os.path.join(self.dir, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
