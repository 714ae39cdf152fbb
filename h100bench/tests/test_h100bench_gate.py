"""The ``gate.batch64`` cell: the whole run on the CPU at a tiny shape (the
port's plain path) comes out correct, and broken answers do not; the three
roofline readers' counts at the cell's shape, on synthetic spans and on the
port's own spans. On the card (``cuda`` marker): the program passes and the
bf16 control fails at the cell's own size, and one traced run through the
command reports the three shares."""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import pytest
import torch

from h100bench import calibrate, harness, inside, loops
from h100bench.manifest import ROOT, Cell
from h100bench.reference import common
from h100bench.tests.helpers import CPU, SEED
from h100bench.tests.test_h100bench_faults import (answer_altered,
                                                   answer_nan, half_left_out)
from h100bench.tests.test_h100bench_inside import ISSUES, Program, _record
from vv_dsp_tpu_torch.models import SpectralGate
from vv_dsp_tpu_torch.utils import profiling

NAME = "gate.batch64"
TINY = {"channels": 2, "samples": 8192}
STAGES = ("roofline.gate_analysis", "roofline.gate_synthesis")


def _cell() -> Cell:
    """The cell with the probe's fade shortened to fit its tiny rows."""
    cell = Cell(NAME)
    cell.config = dict(cell.config, fields=dict(cell.fields, probe_fade=1024))
    return cell


def _run(wrap=None, seed=SEED) -> dict:
    return harness.run_cell(_cell(), seed, 0.3, False, CPU,
                            time.perf_counter(), wrap=wrap,
                            shape_override=TINY, log=lambda line: None)


def no_gate(call):
    """The threshold at 0: every bin passes, the probe's noise floor too."""
    return SpectralGate(threshold=0.0, device="cpu")


def rows_swapped(call):
    return lambda x: call(x).flip(0)


@pytest.mark.parametrize("seed", [SEED, 7, 2**33 + 1])
def test_cell_correct_on_the_cpu(seed):
    res = _run(seed=seed)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"throughput_msps", "setup_s"}
    (check,) = res["checks"].values()
    assert check["value"] < check["limit"] / 20


@pytest.mark.parametrize("fault", [no_gate, rows_swapped, half_left_out,
                                   answer_altered, answer_nan],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    res = _run(wrap=fault)
    assert res["correct"] is False and res["failed"] >= 1


def test_work_at_the_cell_shape():
    cell = Cell(NAME)
    args = (cell.fields, cell.channels(), cell.samples())
    frames = 64 * common.num_frames(479232 + 1536, 1024, 256)
    assert frames == 64 * 1876
    whole = cell.reader("roofline.gate").work_s(*args)
    # two float32 FFTs a frame bind: 0.0918 ms against the bytes' 0.0732
    assert whole == pytest.approx(2 * frames * 25600 / 67e12)
    assert 8 * 64 * 479232 / 3.35e12 < whole
    spectrum = 8 * frames * 513
    stage = 4 * 64 * 480768 + spectrum
    for metric in STAGES:
        got = cell.reader(metric).work_s(*args)
        assert got == pytest.approx(stage / 3.35e12)
        assert got * 1e3 == pytest.approx(0.1838, abs=1e-4)
    assert sum(cell.reader(m).work_s(*args) for m in STAGES) >= whole


def test_whole_call_reads_from_busy_time():
    cell = Cell(NAME)
    reader = cell.reader("roofline.gate")
    work = reader.work_s(cell.fields, cell.channels(), cell.samples())
    rec = {"fields": cell.fields, "channels": cell.channels(),
           "samples": cell.samples(),
           "trace": {"busy_s": 2 * work * 40, "calls": 40}}
    assert reader.read(rec) == pytest.approx(50.0)
    assert reader.read({"trace": None}) is None


@pytest.mark.parametrize("metric", STAGES)
def test_stage_at_its_least_time_reads_100(monkeypatch, metric):
    cell = Cell(NAME)
    work_ms = cell.reader(metric).work_s(cell.fields, cell.channels(),
                                         cell.samples()) * 1e3
    name = "gate." + metric.split("_")[-1]
    p = Program()
    for t0, ms in ((1.0, work_ms), (3.0, work_ms), (5.0, 1e-6)):
        root = p.add("gate", t0, t0 + 0.5)
        p.add(name, t0, t0 + 0.2, root, device_ms=ms)
    monkeypatch.setattr(inside, "recorded", lambda: p.recs)
    assert cell.reader(metric).read(_record(NAME, ISSUES)) == pytest.approx(
        100.0)
    # a program without the span (a tree older than it) reads nothing
    monkeypatch.setattr(inside, "recorded",
                        lambda: [r for r in p.recs if r.name == "gate"])
    assert cell.reader(metric).read(_record(NAME, ISSUES)) is None


def test_port_spans_inside_traced_calls():
    """Three calls of the cell's program on the CPU inside traced harness
    calls under a profiler: each holds the root ``gate`` and its two
    stages; the stages carry no device time on the CPU, so the stage
    rooflines read nothing there."""
    cell = _cell()
    gate = cell.entries().call(cell.fields, CPU)
    x = cell.entries().prepare(cell.fields, torch.randn((2, 8192)))
    gate(x)
    spans = loops.Spans()
    spans.tracer = types.SimpleNamespace(active=True)
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            with spans.span("issue"):
                gate(x)
    rec = dict(_record(NAME, []), spans=spans)
    names = [sp.name for sp in inside.program_spans(rec)]
    assert sorted(names) == sorted(["gate", "gate.analysis",
                                    "gate.synthesis"] * 3)
    for metric in STAGES:
        assert cell.reader(metric).read(rec) is None
    profiling.clear_spans()


# ---- on the card -------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_control_fails_and_program_passes(card):
    cell = Cell(NAME)
    limits = cell.reference().LIMITS["call"]
    control = cell.reference().CONTROL["call"]
    prog = harness.Program(cell, card)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = calibrate.reading(cell, prog, seed, 1.0, card)
        assert all(r[k] < lim for k, lim in limits.items()), r
    for seed in (2**31 + 201, 2**31 + 202, 2**31 + 203):
        r = calibrate.reading(cell, prog, seed, 1.0, card, control)
        assert any(r[k] >= lim for k, lim in limits.items()), r


@pytest.mark.cuda
def test_traced_run_through_the_command(card):
    r = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload",
                        NAME, "--seed", str(2**31 + 7), "--seconds", "2",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    for metric in ("roofline.gate",) + STAGES:
        assert 0 < res["metrics"][metric]["value"] <= 100
