"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` is the whole run after the look for a card; ``main`` (called
by ``run.py``) adds that look and prints. The pieces are separate so that
the calibration (``calibrate.py``) and the tests can drive them: the
tests run the same path on the CPU at a small size, with the timed path
broken underneath, and see ``correct`` come out false.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from h100bench import check as _check
from h100bench import loops
from h100bench import tracing
from h100bench.manifest import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "vv_dsp_tpu")
WARM_CALLS = 2
# a traced closed loop's calls after the window with the device drained
# before each, for the host's own time a call (``issue_drained`` spans)
DRAINED_S = 1.0


class Program:
    """The system under test, built by the configuration's entry file
    (``entries/<config>.py``): the function the traffic mix's ``entry``
    names, given the fields (``fields`` overrides some of them, as a control
    of kind ``program`` does) and the device. It returns a callable for a
    closed loop, or (init(channels), step(state, x)) for a stream. The
    file's optional ``prepare(fields, x)`` turns each input of a closed
    loop's pool, once in set-up, into what the call takes (such as a file
    on disk)."""

    def __init__(self, cell: Cell, device: torch.device,
                 fields: dict | None = None):
        mod = cell.entries()
        fields = dict(cell.fields, **(fields or {}))
        built = getattr(mod, cell.traffic["entry"])(fields, device)
        self.device = device
        self.channels = cell.channels()
        prepare = getattr(mod, "prepare", None)
        self.prepare = ((lambda x: x) if prepare is None
                        else (lambda x: prepare(fields, x)))
        if cell.traffic["loop"] == "closed":
            self.call = built
        else:
            self._init, self.step = built

    def init(self):
        return self._init(self.channels)


def warm_up(cell: Cell, prog: Program, inputs: dict) -> None:
    """The cell's own shapes, each twice: the first call builds or loads
    the kernel library and fills the launch and plan caches. A closed
    loop's inputs are prepared here, once."""
    dev = prog.device
    if cell.traffic["loop"] == "closed":
        if "args" not in inputs:
            inputs["args"] = [prog.prepare(x) for x in inputs["pool"]]
        for x in inputs["args"][:2]:
            for _ in range(WARM_CALLS):
                prog.call(loops.copy_in(x, dev, inputs["pinned"]))
    else:
        state = prog.init()
        for k in range(min(2 * WARM_CALLS, inputs["blocks"].shape[0])):
            _, state = prog.step(state, inputs["blocks"][k].to(
                dev, non_blocking=True))
    loops.sync(dev)


def window(cell: Cell, prog: Program, inputs: dict, seconds: float,
           seed: int, trace: bool, wrap=None) -> dict:
    """The measured window. Returns the loop's record with the spans, the
    answers kept for the check and, traced, the stretch's summary; a
    traced closed loop then makes its drained calls, outside the window."""
    dev = prog.device
    spans = loops.Spans()
    tracer = None
    if trace:
        tracer = tracing.Tracer(dev, loops.clock() + seconds / 4,
                                cell.traffic["trace_seconds"])
        spans.tracer = tracer
    t = cell.traffic
    gc.collect()
    gc.freeze()
    if t["loop"] == "closed":
        call = prog.call if wrap is None else wrap(prog.call)
        sampler = loops.Sampler(t["sample"], seed)
        rec = loops.closed_loop(call, inputs, seconds, dev,
                                t.get("sync_each", False), spans, sampler,
                                tracer)
        rec["answers"] = sampler.answers()
        if trace:
            loops.drained_calls(call, inputs, DRAINED_S, dev, spans)
    else:
        step = prog.step if wrap is None else wrap(prog.step)
        interval = t["block"] / cell.fields["sample_rate"]
        rec = loops.open_loop(step, prog.init(), inputs, interval, dev,
                              spans, tracer)
    gc.unfreeze()
    rec["spans"] = spans
    rec["trace"] = tracer.summary() if tracer is not None else None
    return rec


def compare(cell: Cell, inputs: dict, rec: dict, device: torch.device,
            control_call=None) -> tuple[dict, list[dict]]:
    """The numbers of the window's answers against the reference; with
    control_call (fields, x) -> answer, of that in the program's place."""
    ref = cell.reference()
    if cell.traffic["loop"] == "closed":
        pool = inputs["pool"]
        if control_call is None:
            got = [(p, lambda r, o=o: o[r]) for _, p, o in rec["answers"]]
        else:
            got = [(p, lambda r, p=p: control_call(
                cell.fields, pool[p].to(device)[r]))
                for p in sorted({p for _, p, _ in rec["answers"]})]
        return _check.compare_calls(ref, cell.fields, pool, got, device)
    return _check.compare_stream(ref, cell.fields, inputs["blocks"],
                                 rec["outputs"], device)


def record_for_readers(cell: Cell, rec: dict, setup_s: float) -> dict:
    return {"setup_s": setup_s, "window_s": rec["window_s"],
            "calls": rec["calls"], "channels": cell.channels(),
            "samples": cell.samples(), "fields": cell.fields,
            "traffic": cell.traffic, "spans": rec["spans"],
            "latencies_s": rec.get("latencies_s"), "trace": rec["trace"]}


def read_metrics(cell: Cell, metrics: list[dict], record: dict) -> dict:
    """Each metric's reader, by name; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = cell.reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, wrap=None,
             shape_override: dict | None = None,
             log=lambda line: print(line, file=sys.stderr)) -> dict:
    """One run: set-up, window, memory reading, check, metrics. Returns
    the result object, its "checks" key last."""
    if shape_override:
        cell.traffic = dict(cell.traffic, **shape_override)
    prog = Program(cell, device)
    inputs = loops.make_inputs(cell, seed, device, seconds)
    warm_up(cell, prog, inputs)
    if trace:
        tracing.warm_profiler(lambda: warm_up(cell, prog, inputs))
    loops.sync(device)
    setup_s = time.perf_counter() - t_start
    rec = window(cell, prog, inputs, seconds, seed, trace, wrap)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, each = compare(cell, inputs, rec, device)
    ref = cell.reference()
    correct, failed, checks = _check.verdict(
        ref.LIMITS[cell.traffic["entry"]], numbers, each)
    record = record_for_readers(cell, rec, setup_s)
    metrics = read_metrics(cell, cell.per_layer if trace
                           else cell.end_to_end, record)
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": rec["calls"],
              "failed": int(failed), "metrics": metrics, "device": dev_info}
    summary = rec["trace"]
    if summary is not None:
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    if "latencies_s" in rec:
        late = np.asarray(rec["late_s"]) * 1e3
        log(f"stream: blocks={rec['calls']} "
            f"generator_late_ms_max={late.max():.4f} "
            f"generator_late_ms_p95={np.percentile(late, 95):.4f} "
            f"window_s={rec['window_s']:.4f}")
    for name, c in checks.items():
        log(f"check {name}: {c['value']:.6e} limit {c['limit']:g}")
    result["checks"] = checks
    return result
