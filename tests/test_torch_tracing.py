"""The port's own spans (``vv_dsp_tpu_torch.utils.profiling.span``): off
without a profiler, on under ``torch.profiler``.

Off, the chain, ``SpectralGate``, ``STFT.process``, ``fir_apply_best`` and
the live stream leave no record and call no ``record_function``. Under a
CPU profiler each entry records exactly the spans of PERF.md's table (the
chain's two stages, the gate's two on its split route and one on its
full-nfft route, the stream's four steps, the STFT entry, one ``fir`` root
a ``fir_apply_best`` call on each of its four routes at any rank; a kernel
wrapper's span opens only past its CPU return, so on the CPU there is
none), with their parents, one call id a root and its descendants, each
span inside its parent's host interval, and each a ``user_annotation`` of
its name in the exported Chrome trace.
The ring drops its oldest records past its bound and counts them; a
device span's timing events are reused once the card has passed them; no
span takes a name of the benchmark harness's own ranges; the gate counts
its calls by route. On the card (``cuda`` marker), every one of the 15
kernel wrappers records one ``kernel.<wrapper>`` span a call, inside the
entry's span, the chain's and the gate's two stages carry device
times, and the ``fir`` span does on its first and ninth call, holding its
route's kernel span.
"""

import collections
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.models import (NorthStarChain, SpectralGate,
                                     StreamingNorthStar)
from vv_dsp_tpu_torch.ops import filter_kernels
from vv_dsp_tpu_torch.ops.filter_kernels import fir_apply_best
from vv_dsp_tpu_torch.ops.fir import design_lowpass
from vv_dsp_tpu_torch.ops.stft import STFT
from vv_dsp_tpu_torch.utils import profiling

PORT = Path(profiling.__file__).resolve().parents[1]
# the benchmark harness's range names (h100bench/tracing.py): a program
# span under one of these would change how idle gaps are attributed
HARNESS = ("stretch", "service", "copy_in", "issue", "wait", "pace")
KERNELS = ("upfirdn_banded", "stft_spectrum", "stft_power", "stft_mfcc",
           "istft", "stft_gate_packed", "stft_spectrum_stockham",
           "stft_power_stockham", "stft_mel_stockham", "stft_gate_stockham",
           "istft_stockham", "stft_power_dft", "fir_direct",
           "resample_poly_kernel", "fir_os")
# fir_apply_best's taps on each of its routes: the direct kernel, the
# block-Toeplitz matmuls, the banded upfirdn (at bf16x3, FIR_PRECISION),
# the overlap-save kernel
FIR_TAPS = {"fir_direct": 16, "fir_mxu": 64, "fir_banded": 1024,
            "fir_os": 1024}
# the matmul-precision knob each route's calls run under
FIR_PRECISION = {"fir_banded": "high"}
# each entry's spans on the CPU as (name, parent), in the order they start
ENTRY_SPANS = {
    "chain": [("chain", None), ("chain.head", "chain"),
              ("chain.mfcc", "chain")],
    "chain_staged": [("chain", None), ("chain.head", "chain"),
                     ("fir", "chain.head"), ("chain.mfcc", "chain")],
    "fir_banded": [("fir", None)],
    "fir_direct": [("fir", None)],
    "fir_mxu": [("fir", None)],
    "fir_os": [("fir", None)],
    "gate": [("gate", None), ("gate.analysis", "gate"),
             ("gate.synthesis", "gate")],
    "stft": [("stft", None)],
    "stft_3d": [("stft", None)],
    "stream": [("stream", None), ("stream.fir", "stream"),
               ("stream.resample", "stream"), ("stream.frames", "stream"),
               ("stream.mfcc", "stream")],
}


def _entry(name: str, device):
    """A call of one entry on small inputs, as a function of nothing."""
    g = torch.Generator().manual_seed(5)
    if name.startswith("chain"):
        chain = NorthStarChain(fused_head=name == "chain", device=device)
        x = torch.randn((2, 9600), generator=g).to(device)
        return lambda: chain(x)
    if name.startswith("fir"):
        h = design_lowpass(FIR_TAPS[name], 0.45, device=device)
        x = torch.randn((2, 4800), generator=g).to(device)
        return lambda: _fir_call(name, h, x)
    if name == "gate":
        gate = SpectralGate(device=device)
        x = torch.randn((2, 4800), generator=g).to(device)
        return lambda: gate(x)
    if name.startswith("stft"):
        shape = (3, 2, 4800) if name == "stft_3d" else (2, 4800)
        x = torch.randn(shape, generator=g).to(device)
        plan = STFT(1024, 256)
        return lambda: plan.process(x, rfft=False)
    stream = StreamingNorthStar()
    state = stream.init((2,), device=device)
    block = torch.randn((2, 1536), generator=g).to(device)
    return lambda: stream.process(state, block)


def _fir_call(route: str, h, x):
    """fir_apply_best(h, x) under the precision that takes `route`."""
    with config.matmul_precision(FIR_PRECISION.get(route, "highest")):
        return fir_apply_best(h, x)


def _profiled(fn, activities=(torch.profiler.ProfilerActivity.CPU,)):
    with torch.profiler.profile(activities=list(activities)) as prof:
        fn()
    return prof


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.mark.parametrize("name", sorted(ENTRY_SPANS))
def test_no_profiler_no_spans(name):
    fn = _entry(name, "cpu")
    fn()
    fn()
    assert profiling.spans() == []
    assert profiling.spans_dropped() == 0


def test_off_span_is_one_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first = profiling.span("chain")
    assert profiling.span("chain.head",
                          device=torch.device("cuda", 0)) is first
    with first as got:
        assert got is None
    _entry("stft", "cpu")()
    assert profiling.spans() == []


@pytest.mark.parametrize("name", sorted(ENTRY_SPANS))
def test_entry_records_its_spans(name, tmp_path):
    fn = _entry(name, "cpu")
    fn()                                   # plans and tables built outside
    prof = _profiled(fn)
    recs = sorted(profiling.spans(), key=lambda r: r.start)
    assert [(r.name, r.parent) for r in recs] == ENTRY_SPANS[name]
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs)
    root = recs[0]
    assert root.call == root.id and root.parent_id is None
    for r in recs[1:]:
        parent = by_id[r.parent_id]
        assert parent.name == r.parent and r.call == root.id
        assert parent.start <= r.start <= r.end <= parent.end
    for r in recs:     # siblings one after the other
        sibs = [s for s in recs if s.parent_id == r.parent_id and s is not r]
        assert all(s.end <= r.start or r.end <= s.start for s in sibs)
    assert all(r.device_ms is None for r in recs)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = collections.Counter(e["name"] for e in events
                              if e.get("cat") == "user_annotation")
    for span_name, count in collections.Counter(r.name for r in recs).items():
        assert ann[span_name] == count


def test_call_ids_separate_calls():
    fn = _entry("stream", "cpu")
    fn()
    _profiled(lambda: (fn(), fn()))
    recs = profiling.spans()
    roots = [r for r in recs if r.parent is None]
    assert len(roots) == 2 and roots[0].call != roots[1].call
    for root in roots:
        assert sum(r.call == root.id for r in recs) == 5


def test_parent_restored_after_an_exception():
    def body():
        with pytest.raises(KeyError):
            with profiling.span("a"):
                with profiling.span("b"):
                    raise KeyError
        with profiling.span("c"):
            pass

    _profiled(body)
    recs = {r.name: r for r in profiling.spans()}
    assert recs["b"].parent == "a"
    assert recs["c"].parent is None and recs["c"].call == recs["c"].id


def test_trace_exports_the_spans(tmp_path):
    fn = _entry("chain", "cpu")
    fn()
    with profiling.trace(str(tmp_path)):
        fn()
    (path,) = tmp_path.glob("trace_*.json")
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"chain", "chain.head", "chain.mfcc"} <= names
    assert sorted(r.name for r in profiling.spans()) == sorted(
        n for n, _ in ENTRY_SPANS["chain"])


def test_ring_drops_its_oldest(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=4))

    def six():
        for k in range(6):
            with profiling.span(f"s{k}"):
                pass

    _profiled(six)
    assert [r.name for r in profiling.spans()] == ["s2", "s3", "s4", "s5"]
    assert profiling.spans_dropped() == 2
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


class _FakeEvent:
    """A CUDA timing event's stand-in: done as soon as it is recorded
    unless the card is held busy."""

    made = 0
    busy = False

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.done = False

    def record(self, stream=None):
        self.done = not _FakeEvent.busy

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return 0.25


class _FakeStream:
    device_index = 0


@pytest.mark.parametrize("every", [1, 8])
@pytest.mark.parametrize("busy", [False, True])
def test_device_spans_sample_and_reuse_their_events(monkeypatch, busy,
                                                    every):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(_FakeEvent, "busy", busy)
    monkeypatch.setattr(profiling, "_free_events", {})
    monkeypatch.setattr(profiling, "DEVICE_EVERY", every)
    card = torch.device("cuda", 0)

    def loop():
        for _ in range(50):
            with profiling.span("chain.head", device=card):
                pass
            with profiling.span("chain.mfcc", device=card):
                pass

    _profiled(loop)
    timed = len(range(0, 50, every))        # the first, then every k-th
    # a card that keeps up frees each span's pair for the next; a busy one
    # frees none, and every timed span takes two new events
    assert _FakeEvent.made == (4 * timed if busy else 2)
    recs = profiling.spans()
    assert len(recs) == 100
    for name in ("chain.head", "chain.mfcc"):
        got = [r.device_ms for r in recs if r.name == name]
        assert got[::every] == [0.25] * timed
        assert sum(v is not None for v in got) == timed
    assert len(profiling._free_events[0]) == _FakeEvent.made
    assert not profiling._pending
    # clearing starts each name's count again: its next span is timed
    profiling.clear_spans()
    _profiled(loop)
    assert profiling.spans()[0].device_ms == 0.25


def _span_names_in_source() -> set[str]:
    pat = re.compile(r'profiling\.span\(\s*"([^"]+)"')
    names = set()
    for path in PORT.rglob("*.py"):
        names |= set(pat.findall(path.read_text()))
    return names


def test_span_sites_and_no_harness_name():
    names = _span_names_in_source()
    want = {"chain", "chain.head", "chain.mfcc", "stream", "stream.fir",
            "stream.resample", "stream.frames", "stream.mfcc", "stft",
            "gate", "gate.analysis", "gate.synthesis", "gate.fused", "fir"}
    assert names == want | {f"kernel.{k}" for k in KERNELS}
    assert not names & set(HARNESS)
    # the wrappers with spans are the ones that count their launches
    counted = {k for m in _wrapper_modules() for k in KERNELS
               if hasattr(getattr(m, k, None), "launches")}
    assert counted == set(KERNELS)


@pytest.mark.parametrize("nfft,hop,route", [(1024, 256, "split"),
                                            (128, 32, "full_nfft"),
                                            (128, 24, "torch")])
def test_gate_counts_its_routes(nfft, hop, route):
    gate = SpectralGate(nfft, hop, device="cpu")
    x = torch.randn((2, 3, 1200), generator=torch.Generator().manual_seed(8))
    before = dict(SpectralGate.route_calls)
    gate(x)                              # (2, 3, n): one call of 6 rows
    gate(x[0])
    after = SpectralGate.route_calls
    assert set(after) == {"split", "full_nfft", "torch"}
    assert {k: after[k] - before[k] for k in after} == {
        k: 2 if k == route else 0 for k in after}


def test_gate_fused_route_records_its_span():
    gate = SpectralGate(128, 32, device="cpu")
    x = torch.randn((2, 1200), generator=torch.Generator().manual_seed(9))
    gate(x)
    _profiled(lambda: gate(x))
    assert [(r.name, r.parent) for r in sorted(
        profiling.spans(), key=lambda r: r.start)] == [
        ("gate", None), ("gate.fused", "gate")]


@pytest.mark.parametrize("shape", [(4800,), (2, 4800), (2, 3, 1600)],
                         ids=["rank1", "rank2", "rank3"])
@pytest.mark.parametrize("route", sorted(FIR_TAPS))
def test_fir_records_one_root_a_call_at_any_rank(route, shape):
    h = design_lowpass(FIR_TAPS[route], 0.45, device="cpu")
    x = torch.randn(shape, generator=torch.Generator().manual_seed(12))
    want = _fir_call(route, h, x)
    _profiled(lambda: (_fir_call(route, h, x), _fir_call(route, h, x)))
    recs = profiling.spans()
    assert [(r.name, r.parent) for r in recs] == [("fir", None)] * 2
    assert recs[0].call != recs[1].call
    assert want.shape == x.shape


def test_fir_span_times_the_device_on_the_first_and_every_8th(monkeypatch):
    """fir_apply_best opens its span with the input's device: given a CUDA
    device (a stand-in here), the first and every 8th ``fir`` span carry
    device times, the others none."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(_FakeEvent, "busy", False)
    monkeypatch.setattr(profiling, "_free_events", {})
    card = torch.device("cuda", 0)
    devices = []

    def span(name, device=None):
        devices.append(device)
        return profiling.span(name, device=None if device is None else card)

    monkeypatch.setattr(filter_kernels, "profiling",
                        type("P", (), {"span": staticmethod(span)}))
    h = design_lowpass(16, 0.45, device="cpu")
    x = torch.randn((2, 600), generator=torch.Generator().manual_seed(13))
    _profiled(lambda: [fir_apply_best(h, x) for _ in range(17)])
    assert devices == [x.device] * 17
    got = [r.device_ms for r in profiling.spans() if r.name == "fir"]
    assert got == [0.25 if k % 8 == 0 else None for k in range(17)]


def _wrapper_modules():
    from vv_dsp_tpu_torch.ops import (filter_kernels, istft_kernels,
                                      stft_kernels, stockham_kernels, upfirdn)
    return (filter_kernels, istft_kernels, stft_kernels, stockham_kernels,
            upfirdn)


# ---- on the card -------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


CUDA_ACTS = (torch.profiler.ProfilerActivity.CPU,
             torch.profiler.ProfilerActivity.CUDA)


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_each_wrapper_records_one_span_a_call(dev, name):
    from test_torch_cuda import _rows_cases
    wrapper, fast, _, shape, dtype, _, _ = _rows_cases(dev)[name]
    torch.manual_seed(int(np.random.default_rng(3).integers(1 << 30)))
    x = torch.randn((4,) + shape, dtype=dtype, device=dev)
    if x.is_complex():
        x[..., 0].imag.zero_()
        x[..., -1].imag.zero_()
    fast(x)
    torch.cuda.synchronize()
    profiling.clear_spans()
    before = wrapper.launches
    _profiled(lambda: (fast(x), fast(x)), CUDA_ACTS)
    assert wrapper.launches == before + 2
    recs = [r for r in profiling.spans() if r.name.startswith("kernel.")]
    assert [r.name for r in recs] == [f"kernel.{name}"] * 2
    assert all(r.end > r.start and r.device_ms is None for r in recs)


@pytest.mark.cuda
def test_chain_stages_carry_device_time_on_the_card(dev):
    chain = NorthStarChain(device=dev)
    x = torch.randn((4, 48000), device=dev)
    chain(x)
    torch.cuda.synchronize()
    profiling.clear_spans()
    _profiled(lambda: chain(x), CUDA_ACTS)
    recs = {r.name: r for r in profiling.spans()}
    assert set(recs) == {"chain", "chain.head", "chain.mfcc",
                         "kernel.upfirdn_banded", "kernel.stft_mfcc"}
    assert recs["chain.head"].device_ms > 0
    assert recs["chain.mfcc"].device_ms > 0
    assert recs["chain"].device_ms is None
    assert recs["kernel.upfirdn_banded"].parent == "chain.head"
    assert recs["kernel.stft_mfcc"].parent == "chain.mfcc"


@pytest.mark.cuda
def test_gate_stages_carry_device_time_on_the_card(dev):
    gate = SpectralGate(device=dev)
    x = torch.randn((4, 48000), device=dev)
    gate(x)
    torch.cuda.synchronize()
    profiling.clear_spans()
    _profiled(lambda: gate(x), CUDA_ACTS)
    recs = {r.name: r for r in profiling.spans()}
    assert set(recs) == {"gate", "gate.analysis", "gate.synthesis",
                         "kernel.stft_spectrum", "kernel.istft"}
    assert recs["gate.analysis"].device_ms > 0
    assert recs["gate.synthesis"].device_ms > 0
    assert recs["gate"].device_ms is None
    assert recs["kernel.stft_spectrum"].parent == "gate.analysis"
    assert recs["kernel.istft"].parent == "gate.synthesis"


@pytest.mark.cuda
def test_stft_span_holds_its_wrapper_on_the_card(dev):
    plan = STFT(1024, 256)
    x = torch.randn((1, 48000), device=dev)
    plan.process(x)
    torch.cuda.synchronize()
    profiling.clear_spans()
    _profiled(lambda: plan.process(x), CUDA_ACTS)
    recs = profiling.spans()
    (root,) = [r for r in recs if r.parent is None]
    (kern,) = [r for r in recs if r.name.startswith("kernel.")]
    assert root.name == "stft" and kern.parent_id == root.id
    assert root.start <= kern.start <= kern.end <= root.end


@pytest.mark.cuda
@pytest.mark.parametrize("route,kernel", [("fir_direct", "fir_direct"),
                                          ("fir_banded", "upfirdn_banded"),
                                          ("fir_mxu", None),
                                          ("fir_os", "fir_os")])
def test_fir_span_holds_its_wrapper_on_the_card(dev, route, kernel):
    h = design_lowpass(FIR_TAPS[route], 0.45, device=dev)
    x = torch.randn((2, 3, 16000), device=dev)
    _fir_call(route, h, x)
    torch.cuda.synchronize()
    profiling.clear_spans()
    _profiled(lambda: [_fir_call(route, h, x) for _ in range(9)], CUDA_ACTS)
    recs = profiling.spans()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["fir"] * 9
    assert [r.device_ms is not None for r in roots] == [True] + [False] * 7 \
        + [True]
    assert all(r.device_ms > 0 for r in roots if r.device_ms is not None)
    kids = [r for r in recs if r.parent is not None]
    want = [] if kernel is None else [f"kernel.{kernel}"] * 9
    assert [r.name for r in kids] == want
    for k in kids:
        root = next(r for r in roots if r.id == k.parent_id)
        assert k.parent == "fir"
        assert root.start <= k.start <= k.end <= root.end
