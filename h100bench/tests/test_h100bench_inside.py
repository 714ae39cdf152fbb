"""The readers of the program's own spans (``h100bench/inside.py`` and the
eight metric files on it): on synthetic records, only the program spans
inside the harness's traced ``issue`` spans count; each reader finds
nothing without a trace or without program spans; a stage whose device
time equals its least time reads 100%; the host readers scale by the
run's untraced over traced calls; the two stages' least times sum to at
least the whole call's; no span of the port takes a name of the harness's
ranges; and the stream's readers on the port's own spans from a CPU
run."""

from __future__ import annotations

import re
import types
from pathlib import Path

import pytest
import torch

from h100bench import inside, loops, tracing
from h100bench.manifest import Cell
from vv_dsp_tpu_torch.utils import profiling
from vv_dsp_tpu_torch.utils.profiling import SpanRecord

STAGES = ("fir", "resample", "frames", "mfcc")
METRICS = {
    "roofline.chain_head": "chain.batch64",
    "roofline.chain_mfcc": "chain.batch64",
    "stage_ms_per_block.fir": "chain.stream1536",
    "stage_ms_per_block.resample": "chain.stream1536",
    "stage_ms_per_block.frames": "chain.stream1536",
    "stage_ms_per_block.mfcc": "chain.stream1536",
    "wrapper_ms_per_call.clip": "stft.clip1s",
    "entry_self_ms_per_call.clip": "stft.clip1s",
}
HOST_METRICS = sorted(m for m in METRICS if not m.startswith("roofline."))


class Program:
    """Span records built by hand: each ``add`` a span of (start, end) s
    under a parent record, or a root."""

    def __init__(self):
        self.recs: list[SpanRecord] = []

    def add(self, name, start, end, parent=None, device_ms=None):
        rid = len(self.recs) + 1
        rec = SpanRecord(name, rid, rid if parent is None else parent.call,
                         None if parent is None else parent.name,
                         None if parent is None else parent.id, start, end,
                         device_ms)
        self.recs.append(rec)
        return rec


def _record(cell_name: str, issues) -> dict:
    cell = Cell(cell_name)
    spans = loops.Spans()
    spans.items = list(issues)
    return {"spans": spans, "fields": cell.fields,
            "channels": cell.channels(), "samples": cell.samples(),
            "traffic": cell.traffic, "trace": None}


def _read(metric: str, rec: dict):
    return Cell(METRICS[metric]).reader(metric).read(rec)


# traced issue spans at [1, 2) and [3, 4); an untraced one at [5, 6)
ISSUES = [("issue", 1.0, 2.0, True), ("pace", 2.0, 3.0, True),
          ("issue", 3.0, 4.0, True), ("issue", 5.0, 6.0, False)]


def _stream_program() -> Program:
    """Two blocks inside traced calls, one in an untraced call and one
    outside any call, the last two with stages 100x longer."""
    p = Program()
    for t0, scale in ((1.0, 1.0), (3.0, 2.0), (5.0, 100.0), (7.0, 100.0)):
        root = p.add("stream", t0 + 0.01, t0 + 0.01 + 0.009 * scale)
        t = root.start
        for k, stage in enumerate(STAGES):
            d = 0.001 * (k + 1) * scale / 2
            p.add(f"stream.{stage}", t, t + d, root)
            t += d
    return p


def test_stream_stages_count_only_traced_calls(monkeypatch):
    p = _stream_program()
    monkeypatch.setattr(inside, "recorded", lambda: p.recs)
    rec = _record("chain.stream1536", ISSUES)
    for k, stage in enumerate(STAGES):
        # blocks 1 and 2: 0.5 (k + 1) ms and twice that
        want = (0.5 * (k + 1) + 1.0 * (k + 1)) / 2
        assert _read(f"stage_ms_per_block.{stage}", rec) == pytest.approx(
            want)
    assert inside.host_ms(rec, "stream") == pytest.approx((9.0 + 18.0) / 2)


def _clip_program() -> Program:
    p = Program()
    for t0, wrapper_ms in ((1.0, 0.02), (3.0, 0.04), (5.0, 5.0)):
        root = p.add("stft", t0, t0 + 1e-4)
        p.add("kernel.stft_spectrum", t0 + 1e-5, t0 + 1e-5 + wrapper_ms / 1e3,
              root)
    return p


def test_wrapper_and_entry_self_time(monkeypatch):
    p = _clip_program()
    monkeypatch.setattr(inside, "recorded", lambda: p.recs)
    rec = _record("stft.clip1s", ISSUES)
    assert _read("wrapper_ms_per_call.clip", rec) == pytest.approx(0.03)
    # roots of 0.1 ms less their wrappers' 0.02 and 0.04 ms
    assert _read("entry_self_ms_per_call.clip", rec) == pytest.approx(0.07)


@pytest.mark.parametrize("metric", HOST_METRICS)
def test_host_readers_scale_to_untraced_calls(monkeypatch, metric):
    cell = METRICS[metric]
    p = _stream_program() if cell == "chain.stream1536" else _clip_program()
    monkeypatch.setattr(inside, "recorded", lambda: p.recs)
    at_par = _read(metric, _record(cell, ISSUES))
    # untraced calls a quarter as long as the traced ones read a quarter
    quarter = ISSUES[:3] + [("issue", 5.0, 5.25, False)]
    assert _read(metric, _record(cell, quarter)) == pytest.approx(
        at_par / 4)
    # without an untraced call there is no scale, and nothing to read
    assert _read(metric, _record(cell, ISSUES[:3])) is None


def test_no_port_span_takes_a_harness_name():
    """The harness attributes the trace's idle gaps by its own ranges'
    names; a program span under one of them would move that attribution.
    """
    port = Path(profiling.__file__).resolve().parents[1]
    pat = re.compile(r'profiling\.span\(\s*"([^"]+)"')
    names = set()
    for path in port.rglob("*.py"):
        names |= set(pat.findall(path.read_text()))
    assert "stream.fir" in names and "kernel.stft_spectrum" in names
    harness = set(tracing.HOST_SPANS) | {"stretch", "service",
                                         "issue_drained"}
    assert not names & harness


@pytest.mark.parametrize("metric", ["roofline.chain_head",
                                    "roofline.chain_mfcc"])
def test_stage_at_its_least_time_reads_100(monkeypatch, metric):
    cell = Cell("chain.batch64")
    work_ms = cell.reader(metric).work_s(cell.fields, cell.channels(),
                                         cell.samples()) * 1e3
    name = "chain." + metric.split("_")[-1]
    p = Program()
    for t0, ms in ((1.0, work_ms), (3.0, work_ms), (5.0, 1e-6)):
        root = p.add("chain", t0, t0 + 0.5)
        p.add(name, t0, t0 + 0.2, root, device_ms=ms)
    monkeypatch.setattr(inside, "recorded", lambda: p.recs)
    rec = _record("chain.batch64", ISSUES)
    assert _read(metric, rec) == pytest.approx(100.0)
    # twice the least time reads half
    p.recs = [r._replace(device_ms=2 * r.device_ms) for r in p.recs
              if r.device_ms]
    assert _read(metric, rec) == pytest.approx(50.0)


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_nothing_to_read(monkeypatch, metric):
    programs = {"chain.batch64": Program(), "chain.stream1536":
                _stream_program(), "stft.clip1s": _clip_program()}
    p = programs[METRICS[metric]]
    if METRICS[metric] == "chain.batch64":
        root = p.add("chain", 1.1, 1.5)
        p.add("chain.head", 1.1, 1.2, root, device_ms=1.0)
        p.add("chain.mfcc", 1.2, 1.3, root, device_ms=1.0)
    monkeypatch.setattr(inside, "recorded", lambda: p.recs)
    assert _read(metric, _record(METRICS[metric], ISSUES)) is not None
    # an untraced run: no traced issue span
    untraced = [(n, s, e, False) for n, s, e, _ in ISSUES]
    assert _read(metric, _record(METRICS[metric], untraced)) is None
    # a program that keeps no spans, or kept none
    for none in (None, []):
        monkeypatch.setattr(inside, "recorded", lambda none=none: none)
        assert _read(metric, _record(METRICS[metric], ISSUES)) is None
    # spans only outside the traced calls
    outside = [r for r in p.recs if r.start >= 5.0]
    monkeypatch.setattr(inside, "recorded", lambda: outside)
    assert _read(metric, _record(METRICS[metric], ISSUES)) is None


def test_recorded_is_none_for_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert inside.recorded() is None


def test_stage_least_times_at_the_cell_shape():
    cell = Cell("chain.batch64")
    args = (cell.fields, cell.channels(), cell.samples())
    head = cell.reader("roofline.chain_head").work_s(*args)
    mfcc = cell.reader("roofline.chain_mfcc").work_s(*args)
    whole = cell.reader("roofline.chain").work_s(*args)
    # the head: x in and y out, 4 (64 * 479232 + 64 * 638976) bytes
    assert head == pytest.approx(4 * 64 * (479232 + 638976) / 3.35e12)
    assert head * 1e3 == pytest.approx(0.0855, abs=5e-5)
    assert mfcc * 1e3 == pytest.approx(0.0707, abs=5e-5)
    assert head + mfcc >= whole


def test_stream_readers_on_the_ports_own_spans():
    """Three blocks of the live stream on the CPU inside traced harness
    calls under a profiler: each stage reads a positive time, and the four
    stay inside the ``stream`` span's mean."""
    cell = Cell("chain.stream1536")
    init, step = cell.entries().stream(cell.fields, torch.device("cpu"))
    state = init(2)
    blocks = torch.randn((3, 2, cell.samples()))
    _, state = step(state, blocks[0])
    spans = loops.Spans()
    spans.tracer = types.SimpleNamespace(active=False)
    with spans.span("issue"):          # an untraced block, for the scale
        _, state = step(state, blocks[0])
    spans.tracer.active = True
    profiling.clear_spans()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        for b in blocks:
            with spans.span("issue"):
                _, state = step(state, b)
    rec = {"spans": spans, "fields": cell.fields, "channels": 2,
           "samples": cell.samples(), "traffic": cell.traffic,
           "trace": None}
    stages = [_read(f"stage_ms_per_block.{s}", rec) for s in STAGES]
    assert all(v > 0 for v in stages)
    assert sum(stages) <= inside.untraced(rec, inside.host_ms(rec, "stream"))
    assert len(inside.program_spans(rec)) == 3 * 5
    profiling.clear_spans()
