"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<name>.json`` (its manifest entry's
``file``), a traffic mix ``traffic/<name>.json``, the correctness limits
of a cell ``limits/<workload>.json``, a per-layer metric
``metrics/<name>.py`` (a ``read(record)`` function), a kernel mapping
``kernels/<name>.json``, the chain of an ensemble other than uVT
``ensembles/<physics.ensemble>.py``; a later change adds a cell, a
metric, a kernel or an ensemble by adding files and manifest entries
only.
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.here = os.path.join(root, "benchmark")
        self.data = _json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.here, "traffic", f"{name}.json"))

    def limits(self, workload: str) -> dict:
        return _json(os.path.join(self.here, "limits", f"{workload}.json"))

    def end_to_end(self, workload: str) -> list:
        """The cell's end-to-end metrics: those without a ``workloads``
        key and those that list it."""
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics read in the cell: those that list it, and
        those without a list whose ``moves`` the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def _module(self, sub: str, name: str):
        """The module ``<sub>/<name>.py``, or None where it is not there."""
        path = os.path.join(self.here, sub, f"{name}.py")
        if not os.path.exists(path):
            return None
        safe = name.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(
            f"{__package__}.{sub}.{safe}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read``."""
        return self._module("metrics", metric).read

    def ensemble(self, name: str):
        """``ensembles/<name>.py`` (its ``build``, ``Chain``,
        ``snapshot`` and ``judge``), or None: the harness's own uVT
        chain."""
        return self._module("ensembles", name)

    def kernels(self) -> list:
        """Every kernel mapping: {name, label, work, fragments}."""
        out = []
        for path in sorted(glob.glob(os.path.join(self.here, "kernels",
                                                  "*.json"))):
            k = _json(path)
            k["name"] = os.path.splitext(os.path.basename(path))[0]
            out.append(k)
        return out

    def peaks(self) -> dict:
        return _json(os.path.join(self.here, "peaks.json"))
