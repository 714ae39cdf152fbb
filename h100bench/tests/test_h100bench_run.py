"""The run's last line, the look for a card, and what the run loads."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from h100bench import harness, tracing
from h100bench.manifest import ROOT
from h100bench.tests.helpers import TINY, tiny_run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_result_keys_and_correct(name):
    res = tiny_run(name)
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] < c["limit"]
    json.dumps(res)


def test_traced_line_has_breakdown():
    """The traced summary from a synthetic stretch: busy, window, the
    device operations and the idle gaps by host span."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "stretch", "ts": 0,
           "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "issue", "ts": 0,
           "dur": 30},
          {"ph": "X", "cat": "user_annotation", "name": "wait", "ts": 60,
           "dur": 40},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70,
           "dur": 10}]
    s = tracing.summarise(ev, 2)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert dict(s["device_ops"]) == pytest.approx(
        {"k1": 20e-6, "k2": 20e-6, "copy": 10e-6})
    # gaps [0, 10) in issue, [40, 70) between spans, [80, 100) in wait
    gaps = dict(s["idle_gaps"])
    assert gaps["issue"] == pytest.approx(10e-6)
    assert gaps["other"] == pytest.approx(30e-6)
    assert gaps["wait"] == pytest.approx(20e-6)
    assert gaps["other.longest"] == pytest.approx(30e-6)
    assert len(s["idle_gaps"]) <= 10 and len(s["device_ops"]) <= 10


def test_no_card_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload",
                        "chain.batch64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_no_jax_in_a_run():
    """Every module a run loads, the harness, the metrics, the references,
    the calibration and the port's entry points, with a whole run on the
    CPU: no top-level name is JAX's or the JAX package's, compared whole
    (vv_dsp_tpu_torch passes)."""
    code = (
        "import sys, h100bench.run, h100bench.calibrate\n"
        "from h100bench.tests.helpers import tiny_run, TINY\n"
        "for name in TINY: tiny_run(name)\n"
        "from h100bench import harness\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'vv_dsp_tpu_torch' in tops, tops\n"
        "print(harness.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vv_dsp_tpu_torch_extra", sys)
    assert "vv_dsp_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_benchmark_files_name_no_jax_source():
    """No file of the benchmark imports JAX or the JAX package, nor reads
    the JAX package's benchmark scripts."""
    bench = ROOT / "h100bench"
    for p in bench.rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        for bad in ("import jax", "from jax", "import vv_dsp_tpu\n",
                    "from vv_dsp_tpu ", "from vv_dsp_tpu.", "chip_smoke",
                    "bench.py", "benchmarks/"):
            assert bad not in text, (p, bad)
