"""Profiling, benchmarking and roofline accounting (counterpart of
``vv_dsp_tpu/utils/profiling.py``).

- :class:`BenchResult` — the reference's bench record {name, elapsed,
  samples/s, RTF, iterations} (bench/bench_framework.h:31-48);
- :func:`benchmark` — that record for any function of tensors: on a CUDA
  tensor the device time of ``iters`` calls by CUDA events, on the CPU
  ``time.perf_counter``;
- :func:`chain_benchmark` — the same over a loop whose every call feeds
  the next, one scalar read at the end, best of ``repeats``;
- :func:`trace` — ``torch.profiler`` over a block, written as a Chrome
  trace (view in Perfetto or chrome://tracing);
- :func:`span`, :func:`spans`, :func:`clear_spans` — the program's own
  spans at its layer boundaries, recorded only while a
  ``torch.profiler`` session runs (``trace()`` or any other);
- :class:`Roofline` — the speed-of-light model of one op: given its FLOPs
  and memory bytes, the attainable time max(flops/peak, bytes/bw) and the
  achieved fraction, for the chips in ``CHIP_SPECS``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import tempfile
import threading
import time
from typing import NamedTuple

import torch

# Peak float32 FLOP/s outside the tensor cores and memory bandwidth per chip:
# the H100 SXM's data-sheet peaks (at its 700 W limit), and a rough figure
# for local CPU runs.
CHIP_SPECS = {
    # name: (f32 TFLOP/s, memory GB/s)
    "h100": (67.0, 3350.0),
    "cpu": (0.5, 50.0),
}


def detect_chip() -> str:
    """"h100" on an H100, "cpu" without a GPU; any other card raises
    ``ValueError``, since the table has no peaks for it."""
    if not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name(0)
    if "H100" in name.upper():
        return "h100"
    raise ValueError(f"no peaks for {name!r} in CHIP_SPECS "
                     f"({sorted(CHIP_SPECS)}); pass chip= explicitly")


@dataclasses.dataclass
class BenchResult:
    """Mirror of vv_dsp_bench_result (bench/bench_framework.h:31-38)."""

    name: str
    elapsed_ms: float
    samples_per_sec: float
    rtf: float  # real-time factor: elapsed / signal duration
    iterations: int

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def _result(name, per_call, n_samples, sample_rate, iters) -> BenchResult:
    return BenchResult(
        name=name,
        elapsed_ms=per_call * 1e3,
        samples_per_sec=n_samples / per_call,
        rtf=per_call / (n_samples / sample_rate),
        iterations=iters,
    )


def _timed_seconds(run, cuda: bool) -> float:
    """Seconds of run(): CUDA events on the card (device time, synchronized
    at the end), the host clock on the CPU."""
    if not cuda:
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _on_cuda(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def benchmark(name: str, fn, *args, n_samples: int | None = None,
              sample_rate: float = 48000.0, iters: int = 20,
              warmup: int = 2) -> BenchResult:
    """Time fn(*args) per call, after ``warmup`` calls (kernel builds
    excluded). On a CUDA tensor: CUDA events around ``iters`` calls; on
    the CPU: ``time.perf_counter``.

    n_samples: samples processed per call (for throughput/RTF); inferred
    from args[0]'s size when omitted.
    """
    if n_samples is None:
        n_samples = int(args[0].numel())
    cuda = _on_cuda(args)
    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn(*args)

    per_call = _timed_seconds(run, cuda) / iters
    return _result(name, per_call, n_samples, sample_rate, iters)


def chain_benchmark(name: str, step, x, n_samples: int | None = None,
                    sample_rate: float = 48000.0,
                    iters: int = 200, repeats: int = 3) -> BenchResult:
    """A loop of ``iters`` calls in which call k + 1 depends on call k,
    one scalar read (``.item()``) at the end; the best of ``repeats``, on
    the card by CUDA events, after one loop of warm-up.

    step(x, acc_scalar) -> scalar must fold ``acc`` (a device scalar) into
    its input (e.g. ``x + acc * 1e-30``) AND reduce the FULL output (e.g.
    sum): consuming only a slice times less work than a caller's call.
    """
    if n_samples is None:
        n_samples = int(x.numel())
    cuda = x.is_cuda

    def run():
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(iters):
            acc = step(x, acc)
        return acc.item()

    run()  # warm-up: kernel builds, caches
    best = min(_timed_seconds(run, cuda) for _ in range(max(1, repeats)))
    return _result(name, best / iters, n_samples, sample_rate, iters)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler over the block (CPU activity, and CUDA activity where
    a GPU is present), written on exit as a Chrome trace
    ``trace_<pid>_<ns>.json`` in ``log_dir`` (default ``torch-trace`` in
    the temporary directory). Yields log_dir. While it runs the program's
    spans (``span``) are on: each is a ``user_annotation`` range of its
    name in the trace, and a record in ``spans()``."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# The program's spans. A span is a host interval at one of the program's
# layer boundaries (the table in PERF.md names each site and what reads
# it). It records only while a torch.profiler session is active; otherwise
# it costs one check and returns a shared no-op context.

SPAN_RING = 1 << 20     # records kept; the oldest drop first past it
# a device span times the card on the first and every DEVICE_EVERY-th span
# of its name: with the profiler on, each event record is a traced CUDA
# call that adds to the host's time a span
DEVICE_EVERY = 8

_profiler_on = torch._C._autograd._profiler_enabled
_ring: collections.deque = collections.deque(maxlen=SPAN_RING)
_ring_lock = threading.Lock()
_dropped = 0
_pending: collections.deque = collections.deque()   # device spans unread
_free_events: dict = {}     # device index -> timing events read and free
_device_spans: dict = {}    # span name -> device spans opened
_ids = itertools.count(1)
_open = threading.local()   # .top: the innermost span open on the thread


class SpanRecord(NamedTuple):
    """One span: its name and id, its call (the id of the root span it
    ran under; a root's own id), its parent's name and id (None at a
    root), its host interval on ``time.perf_counter``'s clock (s), and its
    device time (ms, CUDA events) or None."""

    name: str
    id: int
    call: int
    parent: str | None
    parent_id: int | None
    start: float
    end: float
    device_ms: float | None


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _resolve(rec: list) -> None:
    """A device span's time from its two events, which go back to the
    free list."""
    rec[7] = rec[8].elapsed_time(rec[9])
    _free_events.setdefault(rec[10], []).extend(rec[8:10])
    rec[8] = rec[9] = None


def _event(device: int):
    """A timing event of the device: a free one, after those of the device
    spans the card has finished are read and freed, or a new one. So a
    traced loop creates events only while its first calls are queued."""
    with _ring_lock:
        if not _free_events.get(device):
            while _pending and _pending[0][9].query():
                _resolve(_pending.popleft())
        if _free_events.get(device):
            return _free_events[device].pop()
    return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "stream", "rf", "id", "call", "parent", "ev0",
                 "start")

    def __init__(self, name: str, stream):
        self.name, self.stream = name, stream

    def __enter__(self):
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        self.parent = getattr(_open, "top", None)
        self.id = next(_ids)
        self.call = self.id if self.parent is None else self.parent.call
        _open.top = self
        self.ev0 = None
        if self.stream is not None:
            self.ev0 = _event(self.stream.device_index)
            self.ev0.record(self.stream)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        ev1 = None
        if self.ev0 is not None:
            ev1 = _event(self.stream.device_index)
            ev1.record(self.stream)
        _open.top = self.parent
        self.rf.__exit__(*exc)
        parent = self.parent
        _keep([self.name, self.id, self.call,
               None if parent is None else parent.name,
               None if parent is None else parent.id, self.start, end,
               None, self.ev0, ev1,
               None if ev1 is None else self.stream.device_index])
        return False


def _keep(rec: list) -> None:
    global _dropped
    with _ring_lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(rec)
        if rec[8] is not None:
            _pending.append(rec)


def span(name: str, device: torch.device | None = None):
    """A context manager around one layer boundary of the program. Off
    (no torch.profiler session active) it returns a shared no-op context.
    On, it opens a ``record_function`` range of ``name`` (so it sits in the
    profiler's trace, on the device trace's clock), reads
    ``time.perf_counter`` inside that range at start and end, keeps the span
    open on this thread as its parent and the root's id as its call, and,
    with ``device`` a CUDA device, on the first and every
    ``DEVICE_EVERY``-th span of the name, records two timing events on the
    device's current stream (reused from a pool once the card has passed
    them), resolved when the card has or when ``spans()`` reads them."""
    if not _profiler_on():
        return _OFF
    stream = None
    if device is not None and device.type == "cuda":
        k = _device_spans.get(name, 0)
        _device_spans[name] = k + 1
        if k % DEVICE_EVERY == 0:
            stream = torch.cuda.current_stream(device)
    return _Span(name, stream)


def spans() -> list[SpanRecord]:
    """The kept spans in the order they ended, each span's device time
    resolved (its events synchronised) on the way."""
    with _ring_lock:
        while _pending:
            rec = _pending.popleft()
            rec[9].synchronize()
            _resolve(rec)
        return [SpanRecord(*r[:8]) for r in _ring]


def spans_dropped() -> int:
    """Records dropped from the ring (oldest first) since the last
    ``clear_spans``."""
    return _dropped


def clear_spans() -> None:
    """Empty the ring and zero the dropped count; the next device span of
    each name times the card."""
    global _dropped
    with _ring_lock:
        _ring.clear()
        _pending.clear()
        _device_spans.clear()
        _dropped = 0


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Speed-of-light bound for one op on one chip ("" -> detect_chip();
    a chip not in ``CHIP_SPECS`` raises ``KeyError``)."""

    flops: float
    hbm_bytes: float
    chip: str = ""

    def _specs(self):
        chip = self.chip or detect_chip()
        if chip not in CHIP_SPECS:
            raise KeyError(f"unknown chip {chip!r}; known: "
                           f"{sorted(CHIP_SPECS)}")
        tf, gb = CHIP_SPECS[chip]
        return tf * 1e12, gb * 1e9

    @property
    def compute_bound(self) -> bool:
        peak_f, peak_b = self._specs()
        return self.flops / peak_f > self.hbm_bytes / peak_b

    @property
    def attainable_seconds(self) -> float:
        peak_f, peak_b = self._specs()
        return max(self.flops / peak_f, self.hbm_bytes / peak_b)

    def achieved_fraction(self, measured_seconds: float) -> float:
        """1.0 = at the roofline; <1 = headroom remains."""
        return self.attainable_seconds / max(measured_seconds, 1e-12)


def fir_roofline(channels: int, n: int, taps: int, chip: str = "") -> Roofline:
    """Direct-form FIR: 2*taps FLOPs/sample, one read + one write."""
    return Roofline(flops=2.0 * channels * n * taps,
                    hbm_bytes=4.0 * channels * (2 * n + taps), chip=chip)


def stft_roofline(channels: int, frames: int, nfft: int,
                  chip: str = "") -> Roofline:
    """Per-frame C2C FFT: 5*N*log2(N) FLOPs, frame in + spectrum out."""
    return Roofline(
        flops=5.0 * channels * frames * nfft * math.log2(max(nfft, 2)),
        hbm_bytes=4.0 * channels * frames * (nfft + 2 * nfft), chip=chip)


def resample_roofline(channels: int, n_out: int, taps_pp: int,
                      n_in: int, chip: str = "") -> Roofline:
    """Polyphase: 2*taps_pp FLOPs per output, input read + output write."""
    return Roofline(flops=2.0 * channels * n_out * taps_pp,
                    hbm_bytes=4.0 * channels * (n_in + n_out), chip=chip)
