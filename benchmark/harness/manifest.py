"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``), the kind of cell its mix names
(``kinds/<kind>.py``, whose ``Cell`` drives it), limits
(``checks/<cell>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``, a ``read(record)`` that returns a number or
None)."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = "benchmark"


class Bench:
    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, BENCH)
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.manifest = json.load(f)

    def cell(self, name: str) -> dict:
        for c in self.manifest["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.dir, "traffic", name + ".json")) as f:
            return json.load(f)

    @staticmethod
    def _applies(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.manifest["end_to_end"]
                if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.manifest["per_layer"]
                if self._applies(m, cell)]

    def _load(self, sub: str, name: str):
        path = os.path.join(self.dir, sub, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"bench_{sub}_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def kind(self, name: str):
        """The ``Cell`` class of the traffic kind ``name``."""
        return self._load("kinds", name).Cell

    def reader(self, metric: str):
        return self._load("metrics", metric).read
