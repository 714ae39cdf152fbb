"""The traced stretch of a ``--trace 1`` run and the arithmetic over it.

A stretch of ``trace_seconds`` starts a quarter into the window: the device
is synchronised, ``torch.profiler`` (CPU and CUDA activities) starts, the
harness's spans become profiler ranges, and at the stretch's end the device
is synchronised again and the profiler stops. So the stretch holds the whole
device work of the calls made in it, and the trace says what the host was
doing at every instant. The chrome trace is written to ``TMPDIR``, read and
deleted.

From it: the device's busy time (the union of kernel, memcpy and memset
intervals, so overlapping operations count once), the stretch's length, the
busy time inside the blocks' service spans, the device operations that took
most time, and the idle gaps by the span the host was in.
"""

from __future__ import annotations

import bisect
import collections
import json
import math
import os
import tempfile
import warnings

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("copy_in", "issue", "wait", "pace")


class Tracer:
    def __init__(self, device: torch.device, start_at: float,
                 seconds: float):
        self.device = device
        self.start_at = start_at
        self.stop_at = start_at + seconds
        self.active = False
        self.done = False
        self.calls = 0
        self.prof = None
        self.rf = None

    def tick(self, now: float, calls: int) -> None:
        if self.active:
            self.calls += calls
            if now >= self.stop_at:
                self.stop()
        elif not self.done and now >= self.start_at:
            self.start()

    def start(self) -> None:
        # the profiler warns once that a second profile starts afresh
        warnings.filterwarnings("ignore", message=".*clears events.*")
        torch.cuda.synchronize(self.device)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.rf = torch.autograd.profiler.record_function("stretch")
        self.rf.__enter__()
        self.active = True

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        self.rf.__exit__(None, None, None)
        self.prof.stop()
        self.active = False
        self.done = True

    def finish(self) -> None:
        """The window closed: end a stretch still open."""
        if self.active:
            self.stop()

    def summary(self) -> dict | None:
        """The stretch's figures, read after the window: the trace is
        exported and parsed only then, so a stream's later blocks do not
        wait for it."""
        if self.prof is None or not self.calls:
            return None
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.prof = None
        return summarise(events, self.calls)


def warm_profiler(fn) -> None:
    """One profiled call in set-up, so the profiler's own start-up
    (CUPTI) is not paid inside the window."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        fn()
        torch.cuda.synchronize()


def union(intervals) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def intersect(a, b) -> list[tuple[float, float]]:
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretch [lo, hi) minus the busy intervals."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def summarise(events: list[dict], calls: int) -> dict:
    """Busy and window seconds, service-span figures and the breakdown of
    one stretch's chrome-trace events (times in microseconds)."""
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("ph") == "X"]
    stretch = [e for e in ann if e["name"] == "stretch"]
    if not stretch:
        return None
    lo = stretch[0]["ts"]
    hi = lo + stretch[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    busy = intersect(union((e["ts"], e["ts"] + e["dur"]) for e in dev),
                     [(lo, hi)])
    service = union((e["ts"], e["ts"] + e["dur"]) for e in ann
                    if e["name"] == "service")
    per_op = collections.defaultdict(float)
    for e in dev:
        per_op[e["name"][:160]] += e["dur"]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ann
                  if e["name"] in HOST_SPANS)
    per_gap = collections.defaultdict(float)
    longest = collections.defaultdict(float)
    for s, e in gaps(busy, lo, hi):
        what = _host_span_at((s + e) / 2, host)
        per_gap[what] += e - s
        longest[what] = max(longest[what], e - s)
    idle = [[k, v * 1e-6] for k, v in per_gap.items()]
    idle += [[f"{k}.longest", v * 1e-6] for k, v in longest.items()]
    return {
        "busy_s": length(busy) * 1e-6,
        "window_s": (hi - lo) * 1e-6,
        "calls": calls,
        "service_s": length(service) * 1e-6,
        "service_busy_s": length(intersect(busy, service)) * 1e-6,
        "device_ops": sorted(([k, v * 1e-6] for k, v in per_op.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(idle, key=lambda kv: -kv[1])[:10],
    }


def _host_span_at(t: float, host) -> str:
    """The harness span holding instant t, or "other". The host spans
    (copy-in, issue, wait, pace) never overlap, so the last one to start
    before t is the only candidate."""
    k = bisect.bisect_right(host, (t, math.inf, "")) - 1
    if k >= 0 and host[k][1] >= t:
        return host[k][2]
    return "other"
