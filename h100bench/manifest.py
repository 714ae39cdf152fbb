"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
cells and metrics. Everything that belongs to one of them is a file of its
own, found by name:

- a configuration: the JSON file its manifest entry names (``file``), its
  entry into the program ``entries/<config>.py`` (a function a traffic
  mix's ``entry`` names, building the program from the fields) and its
  plain reference ``reference/<config>.py``;
- a traffic mix: ``traffic/<traffic>.json``, read by the one generator in
  ``loops.py``;
- a metric, end-to-end or per-layer: ``metrics/<metric>.py``, a reader with
  ``read(record) -> float | None``.

So a cell, configuration, mix or metric is added with new files and new
manifest entries, and no file that is there is edited.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


class Cell:
    """One cell of the manifest with everything it names, read from the
    files under ``bench_dir``."""

    def __init__(self, name: str, root: Path = ROOT,
                 bench_dir: Path | None = None):
        root = Path(root)
        self.bench_dir = Path(bench_dir) if bench_dir else root / BENCH_DIR.name
        m = load(root)
        cells = {w["name"]: w for w in m["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        self.chips = self.workload["chips"]
        configs = {c["name"]: c for c in m["configs"]}
        self.config_entry = configs[self.workload["config"]]
        with open(root / self.config_entry["file"]) as f:
            self.config = json.load(f)
        with open(self.bench_dir / "traffic"
                  / f"{self.workload['traffic']}.json") as f:
            self.traffic = json.load(f)
        self.end_to_end = [e for e in m["end_to_end"] if self._reports(e)]
        self.per_layer = [p for p in m["per_layer"] if self._reports(p, m)]

    def _reports(self, metric: dict, manifest: dict | None = None) -> bool:
        """A metric with ``workloads`` is reported in the cells it lists;
        an end-to-end one without, in every cell; a per-layer one
        without, in every cell that reports its ``moves``."""
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if manifest is None:
            return True
        moves = [e for e in manifest["end_to_end"]
                 if e["name"] == metric["moves"]]
        return bool(moves) and self._reports(moves[0])

    @property
    def fields(self) -> dict:
        return self.config["fields"]

    def entries(self):
        """``entries/<config>.py``: a function ``(fields, device)`` -> the
        program for each entry a traffic mix names, and an optional
        ``prepare(fields, x)``."""
        return load_module(self.bench_dir / "entries"
                           / f"{self.workload['config']}.py",
                           f"h100bench.entries.{self.workload['config']}")

    def channels(self) -> int:
        return self.traffic["channels"]

    def samples(self) -> int:
        """Samples a channel of one call (closed loop) or one block (open
        loop)."""
        t = self.traffic
        if t["loop"] == "open":
            return t["block"]
        if "samples" in t:
            return t["samples"]
        return self.config[t["samples_from"]]

    def reference(self):
        return load_module(self.bench_dir / "reference"
                           / f"{self.workload['config']}.py",
                           f"h100bench.reference.{self.workload['config']}")

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           f"h100bench.metrics.{metric}")


def load_module(path: Path, name: str):
    """The module at path, imported under name (metric files carry dots in
    their names, so they are loaded by path, not by import)."""
    if name in sys.modules and getattr(sys.modules[name], "__file__",
                                       None) == str(path):
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
