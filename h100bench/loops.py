"""The traffic generator and the two loops that drive the program.

A traffic mix is a JSON file of parameters (``traffic/<name>.json``):

- ``loop``: ``"closed"`` (one caller, the next call issued when the last
  returns) or ``"open"`` (one block due every block / sample_rate seconds,
  the audio's own real time, whatever the program does);
- ``entry``: the configuration's entry the mix drives (``"call"`` or
  ``"stream"``);
- ``channels``; ``samples`` or ``samples_from`` (a key of the
  configuration) for a call, ``block`` for a stream; ``pool``: distinct
  inputs a closed loop takes in turn;
- ``source``: ``"device"`` (inputs made on the card and left there) or
  ``"pinned"`` (copied in from pinned host memory before each call);
- ``sync_each``: a closed loop synchronises after each call;
- ``sample``: answers a closed loop keeps for the check, drawn from the
  seed, besides the last;
- ``trace_seconds``: the length of the profiled stretch in a traced run.
- ``pacing``: a note on how an open loop's caller waits (it spins to each
  due time), read by no code.

Inputs are white noise, N(0, 1) float32, drawn from the seed on the device
in one call. The same seed gives the same inputs; every seed gives the same
sizes and arrivals.
"""

from __future__ import annotations

import math
import random
import time

import torch

clock = time.perf_counter


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """The harness's host spans: (name, start, end, traced) on the host
    clock. While a tracer is active each span is also a profiler range, so
    the trace can say what the host was doing at any instant."""

    def __init__(self):
        self.items: list[tuple[str, float, float, bool]] = []
        self.tracer = None

    def span(self, name: str):
        return _Span(self, name)

    def of(self, name: str, traced: bool | None = None) -> list[float]:
        """Durations (s) of the spans called name, all or only those (not)
        inside the traced stretch."""
        return [e - s for n, s, e, t in self.items
                if n == name and (traced is None or t == traced)]


class _Span:
    __slots__ = ("spans", "name", "start", "rf")

    def __init__(self, spans: Spans, name: str):
        self.spans, self.name, self.rf = spans, name, None

    def __enter__(self):
        tr = self.spans.tracer
        if tr is not None and tr.active:
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = clock()
        return self

    def __exit__(self, *exc):
        end = clock()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.spans.items.append((self.name, self.start, end,
                                 self.rf is not None))
        return False


class Sampler:
    """The answers kept for the check: a reservoir of k calls drawn from
    the seed, and the last call. Holding a reference keeps the output
    alive; nothing is copied."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed * 2654435761 % 2**61)
        self.kept: dict[int, tuple[int, torch.Tensor]] = {}
        self.last = None

    def offer(self, i: int, pool_index: int, out: torch.Tensor) -> None:
        if i < self.k:
            self.kept[i] = (pool_index, out)
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                victim = sorted(self.kept)[j]
                del self.kept[victim]
                self.kept[i] = (pool_index, out)
        self.last = (i, pool_index, out)

    def answers(self) -> list[tuple[int, int, torch.Tensor]]:
        out = [(i, p, o) for i, (p, o) in sorted(self.kept.items())]
        if self.last is not None and self.last[0] not in self.kept:
            out.append(self.last)
        return out


def make_inputs(cell, seed: int, device: torch.device,
                seconds: float) -> dict:
    """The cell's inputs from the seed: a closed loop's pool of (c, n)
    signals, or an open loop's (K, c, block) blocks, K the blocks due in the
    window. Pinned sources end in pinned host memory."""
    t = cell.traffic
    c = t["channels"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pinned = t["source"] == "pinned"
    if t["loop"] == "closed":
        n = cell.samples()
        data = torch.randn((t["pool"], c, n), generator=gen, device=device)
        return {"pool": list(_host(data, pinned)), "pinned": pinned,
                "samples": n}
    block = t["block"]
    k = blocks_due(seconds, block, cell.fields["sample_rate"])
    data = torch.randn((c, k * block), generator=gen, device=device)
    blocks = data.reshape(c, k, block).transpose(0, 1).contiguous()
    return {"blocks": _host(blocks, pinned), "pinned": pinned,
            "samples": block}


def blocks_due(seconds: float, block: int, sample_rate: float) -> int:
    return max(1, math.ceil(seconds * sample_rate / block))


def _host(t: torch.Tensor, pinned: bool) -> torch.Tensor:
    if not pinned or t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def copy_in(x, device: torch.device, pinned: bool):
    """A pinned input copied to the device; anything else as it is."""
    if pinned and isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return x


def closed_loop(call, inputs: dict, seconds: float, device: torch.device,
                sync_each: bool, spans: Spans, sampler: Sampler,
                tracer=None) -> dict:
    """Calls back to back for `seconds`, then a synchronise: the window
    runs from the first call to the end of that synchronise, so every call
    counted has completed on the device. The calls take the pool's
    prepared inputs (``args``) in turn."""
    args = inputs["args"]
    copy = inputs["pinned"]
    i = 0
    t0 = clock()
    deadline = t0 + seconds
    while True:
        p = i % len(args)
        x = args[p]
        if copy:
            with spans.span("copy_in"):
                x = copy_in(x, device, copy)
        with spans.span("issue"):
            out = call(x)
        if sync_each:
            with spans.span("wait"):
                sync(device)
        sampler.offer(i, p, out)
        del out
        i += 1
        now = clock()
        if tracer is not None:
            tracer.tick(now, calls=1)
        if now >= deadline:
            break
    with spans.span("wait"):
        sync(device)
    end = clock()
    if tracer is not None:
        tracer.finish()
    return {"calls": i, "window_s": end - t0, "t0": t0}


def drained_calls(call, inputs: dict, seconds: float, device: torch.device,
                  spans: Spans) -> int:
    """Calls for `seconds`, the device drained before each: a call's
    ``issue_drained`` span is the host's own time in it, which a full
    launch queue cannot stretch. The outputs are dropped. Returns the
    calls made."""
    args = inputs["args"]
    i = 0
    deadline = clock() + seconds
    while True:
        x = copy_in(args[i % len(args)], device, inputs["pinned"])
        sync(device)
        with spans.span("issue_drained"):
            call(x)
        i += 1
        if clock() >= deadline:
            break
    sync(device)
    return i


def open_loop(step, state, inputs: dict, interval: float,
              device: torch.device, spans: Spans, tracer=None) -> dict:
    """Blocks due every `interval` seconds from the window's start, each
    copied in, processed and waited for in turn. A block's latency runs
    from its due time to its frames being ready on the device; a block
    the program reaches late waits from its due time, so a stall counts
    against every block behind it."""
    blocks = inputs["blocks"]
    copy = inputs["pinned"]
    outs, lat, late = [], [], []
    done = torch.cuda.Event() if device.type == "cuda" else None
    t0 = clock()
    for k in range(blocks.shape[0]):
        due = t0 + k * interval
        with spans.span("pace"):
            _wait_until(due)
        start = clock()
        with spans.span("service"):
            x = blocks[k]
            if copy:
                with spans.span("copy_in"):
                    x = x.to(device, non_blocking=True)
            with spans.span("issue"):
                feats, state = step(state, x)
            with spans.span("wait"):
                if done is not None:
                    done.record()
                    done.synchronize()
        ready = clock()
        outs.append(feats)
        lat.append(ready - due)
        late.append(start - due)
        if tracer is not None:
            tracer.tick(ready, calls=1)
    end = clock()
    if tracer is not None:
        tracer.finish()
    return {"calls": len(outs), "window_s": end - t0, "t0": t0,
            "latencies_s": lat, "late_s": late, "outputs": outs}


def _wait_until(t: float) -> None:
    """Spin until t: the caller starts each block at its due time, as an
    audio thread woken on time by its input does. A sleeping caller on a
    host shared with other work wakes late by a varying amount (at the
    95th percentile 0.3-1.9 ms past a wake-up set 1 ms early, from run to
    run), and that, not the program, would then set the tail."""
    while clock() < t:
        pass
