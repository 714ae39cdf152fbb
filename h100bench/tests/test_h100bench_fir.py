"""The ``fir1024.batch64`` cell: the whole run on the CPU at a tiny shape (the
port's plain path) comes out correct, and broken answers do not;
``roofline.fir``'s count at the cell's shape, on synthetic spans and on the
port's own spans. On the card (``cuda`` marker): the program passes and the
control (the program at bf16x3) fails at the cell's own size, and one traced run through the
command reports ``roofline.fir``."""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import pytest
import torch

from h100bench import calibrate, harness, inside, loops, peaks
from h100bench.manifest import ROOT, Cell
from h100bench.tests.helpers import CPU, SEED
from h100bench.tests.test_h100bench_faults import (answer_altered,
                                                   answer_nan, half_left_out)
from h100bench.tests.test_h100bench_inside import ISSUES, Program, _record
from vv_dsp_tpu_torch.utils import profiling

NAME = "fir1024.batch64"
TINY = {"channels": 2, "samples": 8192}


def _run(wrap=None, seed=SEED) -> dict:
    return harness.run_cell(Cell(NAME), seed, 0.3, False, CPU,
                            time.perf_counter(), wrap=wrap,
                            shape_override=TINY, log=lambda line: None)


def rows_swapped(call):
    return lambda x: call(x).flip(0)


def one_sample_late(call):
    """The answer delayed by one sample, as an off-by-one history would."""
    return lambda x: torch.nn.functional.pad(call(x), (1, 0))[..., :-1]


@pytest.mark.parametrize("seed", [SEED, 7, 2**33 + 1])
def test_cell_correct_on_the_cpu(seed):
    res = _run(seed=seed)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"throughput_msps", "setup_s"}
    (check,) = res["checks"].values()
    # the plain path's f32 tier reads 7-9e-7 here, the bf16x3 control
    # 3.5-4.2e-6 (the limit 3.4e-6)
    assert check["value"] < check["limit"] / 2


@pytest.mark.parametrize("fault", [rows_swapped, one_sample_late,
                                   half_left_out, answer_altered,
                                   answer_nan], ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    res = _run(wrap=fault)
    assert res["correct"] is False and res["failed"] >= 1


def test_work_at_the_cell_shape():
    cell = Cell(NAME)
    c, n = cell.channels(), cell.samples()
    assert (c, n) == (64, 479232)
    got = cell.reader("roofline.fir").work_s(cell.fields, c, n)
    # the bytes bind: 245.4 MB in and out, 0.0732 ms
    assert got == pytest.approx(8 * c * n / 3.35e12)
    assert got * 1e3 == pytest.approx(0.0732, abs=1e-4)
    # the direct form at the f32 tier (six bf16 products) would take
    # 0.381 ms, overlap-save FFTs at float32 0.036 ms
    direct = 2 * c * n * 1024 * 6 / 989e12
    fft = peaks.fir_fft_flops(c, n, 1024) / 67e12
    assert direct * 1e3 == pytest.approx(0.381, abs=1e-3)
    assert fft * 1e3 == pytest.approx(0.036, abs=1e-3)
    assert fft < got < direct


def test_at_its_least_time_reads_100(monkeypatch):
    cell = Cell(NAME)
    work_ms = cell.reader("roofline.fir").work_s(
        cell.fields, cell.channels(), cell.samples()) * 1e3
    p = Program()
    for t0, ms in ((1.0, work_ms), (3.0, work_ms), (5.0, 1e-6)):
        root = p.add("fir", t0, t0 + 0.5, device_ms=ms)
        p.add("kernel.upfirdn_banded", t0, t0 + 0.2, root)
    monkeypatch.setattr(inside, "recorded", lambda: p.recs)
    reader = cell.reader("roofline.fir")
    assert reader.read(_record(NAME, ISSUES)) == pytest.approx(100.0)
    # a program without the span (a tree older than it) reads nothing
    monkeypatch.setattr(inside, "recorded", lambda: [
        r for r in p.recs if r.name != "fir"])
    assert reader.read(_record(NAME, ISSUES)) is None


def test_port_spans_inside_traced_calls():
    """Three calls of the cell's program on the CPU inside traced harness
    calls under a profiler: each holds one root ``fir``; it carries no
    device time on the CPU, so the roofline reads nothing there."""
    cell = Cell(NAME)
    call = cell.entries().call(cell.fields, CPU)
    x = torch.randn((2, 8192))
    call(x)
    spans = loops.Spans()
    spans.tracer = types.SimpleNamespace(active=True)
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            with spans.span("issue"):
                call(x)
    rec = dict(_record(NAME, []), spans=spans)
    got = inside.program_spans(rec)
    assert [(sp.name, sp.parent) for sp in got] == [("fir", None)] * 3
    assert cell.reader("roofline.fir").read(rec) is None
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
    # a control of kind "program" is the program built with its fields, as
    # calibrate.main builds it
    assert control["kind"] == "program"
    prog = harness.Program(cell, card, control["fields"])
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
    assert 0 < res["metrics"]["roofline.fir"]["value"] <= 100
    for metric in ("idle_share.throughput", "host_ms_per_call.throughput"):
        assert metric in res["metrics"]
