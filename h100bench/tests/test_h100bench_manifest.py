"""BENCHMARK.json against the benchmark's contract: names and units of the
allowed characters, every metric's cells reporting its ``moves``, every
file a name points at present, bounds in range."""

from __future__ import annotations

import json
import re

import pytest

from h100bench import manifest
from h100bench.manifest import BENCH_DIR, ROOT, Cell

M = manifest.load()
LINE = re.compile(r"[^\t\n\r]{1,200}")
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == [BENCH_DIR.name]
    assert 1 <= len(M["command"]) <= 32
    for word in M["command"]:
        assert LINE.fullmatch(word) and not word.startswith("/")
        assert ".." not in word
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names(key):
    names = [e["name"] for e in M[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert manifest.NAME.fullmatch(n), n


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        assert c["file"].startswith(BENCH_DIR.name + "/")
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert json.loads((ROOT / c["file"]).read_text())["source"] \
            == c["source"]
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert manifest.NAME.fullmatch(w["config"])
        assert manifest.NAME.fullmatch(w["traffic"])
        assert w["chips"] == 1 and LINE.fullmatch(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}


def test_metric_keys_and_units():
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in M["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.fullmatch(m["layer"])
    for m in METRICS:
        assert manifest.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["better"] == "higher"


def test_every_metric_has_its_reader():
    for m in METRICS:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        moves = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells
            assert "workloads" not in moves or w in moves["workloads"]


@pytest.mark.parametrize("name", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_enough(name):
    cell = Cell(name)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert (BENCH_DIR / "traffic" / f"{cell.workload['traffic']}.json"
            ).is_file()
    assert (BENCH_DIR / "reference" / f"{cell.workload['config']}.py"
            ).is_file()
    assert callable(getattr(cell.entries(), cell.traffic["entry"]))
    ref = cell.reference()
    assert cell.traffic["entry"] in ref.LIMITS
    assert cell.traffic["entry"] in ref.CONTROL


def test_four_chip_cells_within_share():
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(M["workloads"]) // 4)


def test_file_size():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_configuration_files_name_no_width_cut():
    for c in M["configs"]:
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank"))
