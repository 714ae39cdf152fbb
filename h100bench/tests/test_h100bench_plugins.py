"""A configuration, a traffic mix, a reference, a metric and a cell added as
new files (and new manifest entries) in a copy of the benchmark are found by
name, with no file that was there edited, and run end to end on the CPU."""

from __future__ import annotations

import hashlib
import json
import shutil
import time

import pytest
import torch

from h100bench import harness
from h100bench.manifest import BENCH_DIR, ROOT, Cell
from h100bench.tests.helpers import SEED
from h100bench.tests.test_h100bench_faults import answer_altered, half_left_out

CONFIG = {
    "name": "stft_512_128",
    "source": "test configuration",
    "fields": {"nfft": 512, "hop": 128, "window": "hann"},
}
ENTRY = '''from vv_dsp_tpu_torch.ops.stft import STFT


def call(fields, device):
    stft = STFT(fields["nfft"], fields["hop"], fields["window"])
    return lambda x: stft.process(x, rfft=False)
'''
# a function of the library, not a class: its taps designed from the fields
# in set-up, and each input prepared once as a host array, as a file on disk
# would be
FIR_CONFIG = {"name": "fir_1024_03", "source": "test configuration",
              "fields": {"taps": 1024, "cutoff": 0.3}}
FIR_ENTRY = '''import torch

from vv_dsp_tpu_torch.ops.filter_kernels import fir_apply_best
from vv_dsp_tpu_torch.ops.fir import design_lowpass


def prepare(fields, x):
    return x.cpu().numpy()


def call(fields, device):
    h = design_lowpass(fields["taps"], fields["cutoff"], device=device)
    return lambda a: fir_apply_best(h, torch.from_numpy(a).to(device))
'''
FIR_REFERENCE = '''from h100bench.reference import common as C

LIMITS = {"call": {"err_of_scale": 1e-4}}
CONTROL = {"call": {"kind": "reference"}}


def call(fields, x):
    return C.causal_fir(x.double(), C.lowpass(fields["taps"], fields["cutoff"]))
'''
TRAFFIC = {"loop": "closed", "entry": "call", "channels": 3,
           "samples": 4000, "pool": 2, "source": "device",
           "sync_each": False, "sample": 2, "trace_seconds": 0.1}
METRIC = '''"""calls_done: the window's calls (a test metric)."""


def read(rec):
    return rec["calls"]
'''


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _copy(tmp_path):
    bench = tmp_path / BENCH_DIR.name
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return bench, _digest(bench), json.loads(
        (ROOT / "BENCHMARK.json").read_text())


def _add_config(bench, m, config, entry, reference):
    name = config["name"]
    (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
    (bench / "entries" / f"{name}.py").write_text(entry)
    (bench / "reference" / f"{name}.py").write_text(reference)
    m["configs"].append({"name": name, "source": "test",
                         "file": f"{BENCH_DIR.name}/configs/{name}.json",
                         "reduced": [], "why": "test"})


def test_new_files_are_found_by_name(tmp_path):
    bench, before, m = _copy(tmp_path)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TRAFFIC))
    (bench / "metrics" / "calls_done.py").write_text(METRIC)
    _add_config(bench, m, CONFIG, ENTRY,
                (BENCH_DIR / "reference" / "stft_1024_256.py").read_text())
    m["workloads"].append({"name": "stft512.tiny", "config": "stft_512_128",
                           "traffic": "tiny", "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "calls_done", "unit": "calls",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["stft512.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    after = _digest(bench)
    assert all(after[k] == v for k, v in before.items())

    cell = Cell("stft512.tiny", tmp_path)
    assert cell.config["fields"]["nfft"] == 512
    assert cell.traffic["samples"] == 4000
    names = [e["name"] for e in cell.end_to_end]
    assert names == ["setup_s", "calls_done"]
    assert cell.reader("calls_done").read({"calls": 7}) == 7
    res = harness.run_cell(cell, 5, 0.2, False, torch.device("cpu"),
                           time.perf_counter(), log=lambda line: None)
    assert res["correct"] is True
    assert res["metrics"]["calls_done"]["value"] == res["attempted"] > 0


def test_function_style_cell_is_added_as_files(tmp_path):
    """A cell on a library function (fir_apply_best with taps designed
    from the fields, its inputs prepared in set-up) needs only new files
    and entries: the configuration, its entry file, its reference and the
    cell; the traffic mix and the metrics are the ones there."""
    bench, before, m = _copy(tmp_path)
    _add_config(bench, m, FIR_CONFIG, FIR_ENTRY, FIR_REFERENCE)
    m["workloads"].append({"name": "fir1024.tiny", "config": "fir_1024_03",
                           "traffic": "batch", "chips": 1, "why": "test"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if ("chain.batch64" in metric.get("workloads", ())
                and not metric["name"].startswith("roofline")):
            metric["workloads"].append("fir1024.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    after = _digest(bench)
    assert all(after[k] == v for k, v in before.items())

    cell = Cell("fir1024.tiny", tmp_path)
    assert [e["name"] for e in cell.end_to_end] == ["throughput_msps",
                                                    "setup_s"]
    assert [p["name"] for p in cell.per_layer] == [
        "host_ms_per_call.throughput", "idle_share.throughput"]
    res = harness.run_cell(cell, SEED, 0.3, False, torch.device("cpu"),
                           time.perf_counter(),
                           shape_override={"channels": 2, "samples": 6000},
                           log=lambda line: None)
    assert res["correct"] is True and res["attempted"] > 0
    assert res["checks"]["err_of_scale"]["value"] < 1e-5
    assert res["metrics"]["throughput_msps"]["value"] > 0


@pytest.mark.parametrize("fault", [half_left_out, answer_altered])
def test_function_style_cell_fault_is_not_correct(tmp_path, fault):
    bench, _, m = _copy(tmp_path)
    _add_config(bench, m, FIR_CONFIG, FIR_ENTRY, FIR_REFERENCE)
    m["workloads"].append({"name": "fir1024.tiny", "config": "fir_1024_03",
                           "traffic": "batch", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    res = harness.run_cell(Cell("fir1024.tiny", tmp_path), SEED, 0.2, False,
                           torch.device("cpu"), time.perf_counter(),
                           wrap=fault,
                           shape_override={"channels": 2, "samples": 6000},
                           log=lambda line: None)
    assert res["correct"] is False
