"""The program's own spans inside the harness's traced calls, and the
arithmetic of the metrics that read them.

The port records spans at its layer boundaries
(``vv_dsp_tpu_torch.utils.profiling.span``) while a torch.profiler session
runs, as one does through the traced stretch of a ``--trace 1`` run. Each
span's host interval is on ``time.perf_counter``'s clock, as the harness's
spans are, so a program span belongs to a traced call when it lies inside
one of the harness's traced ``issue`` spans. The spans of set-up (the
profiler's warm-up) and of anything outside a traced call are left out.

The host times are read with the profiler on, which adds its cost to every
PyTorch operation and launch inside them; ``untraced`` scales such a time
by the run's own untraced over traced ``issue`` spans, so a call's host
times sum to what an untraced call takes. The profiler's share of a span
follows how many operations it launches, so the scaled split among spans
is not each span's untraced time: compare a scaled time with the same
metric of another run, not with ``host_ms_per_call.clip`` or
``host_ms_per_block.latency``.

Every reader returns None where there is nothing to read: an untraced run,
or a program that records no spans (a tree older than them). A span record
has ``name``, ``id``, ``call`` (the id of its root), ``parent`` and
``parent_id`` (None at a root), ``start`` and ``end`` (s) and ``device_ms``
(CUDA events, or None).
"""

from __future__ import annotations

import bisect


def recorded() -> list | None:
    """The program's span records, or None where the program keeps none."""
    try:
        from vv_dsp_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def program_spans(rec: dict) -> list | None:
    """The program's spans that lie inside a traced ``issue`` span of the
    run's record, or None where there are none."""
    issues = sorted((s, e) for n, s, e, traced in rec["spans"].items
                    if n == "issue" and traced)
    if not issues:
        return None
    spans = recorded()
    if not spans:
        return None
    starts = [s for s, _ in issues]
    inside = []
    for sp in spans:
        k = bisect.bisect_right(starts, sp.start) - 1
        if k >= 0 and sp.end <= issues[k][1]:
            inside.append(sp)
    return inside or None


def _mean(values: list[float]):
    return sum(values) / len(values) if values else None


def device_ms(rec: dict, name: str):
    """The mean device time (ms) of the spans called name."""
    spans = program_spans(rec) or []
    return _mean([sp.device_ms for sp in spans
                  if sp.name == name and sp.device_ms is not None])


def host_ms(rec: dict, name: str):
    """The mean host duration (ms) of the spans called name."""
    spans = program_spans(rec) or []
    return _mean([(sp.end - sp.start) * 1e3 for sp in spans
                  if sp.name == name])


def prefixed_ms_per_call(rec: dict, prefix: str, root: str):
    """The host ms a call spends in spans whose names begin with prefix:
    their summed durations over the number of ``root`` root spans."""
    spans = program_spans(rec) or []
    calls = sum(1 for sp in spans if sp.name == root and sp.parent is None)
    if not calls:
        return None
    total = sum(sp.end - sp.start for sp in spans
                if sp.name.startswith(prefix))
    return total / calls * 1e3


def self_ms(rec: dict, root: str):
    """The mean self time (ms) of the ``root`` root spans: each one's
    duration less its children's."""
    spans = program_spans(rec) or []
    children: dict[int, float] = {}
    for sp in spans:
        if sp.parent_id is not None:
            children[sp.parent_id] = (children.get(sp.parent_id, 0.0)
                                      + sp.end - sp.start)
    return _mean([(sp.end - sp.start - children.get(sp.id, 0.0)) * 1e3
                  for sp in spans if sp.name == root and sp.parent is None])


def untraced(rec: dict, ms):
    """ms, a host time read inside traced calls, times the mean of the
    run's untraced ``issue`` spans over the mean of its traced ones; None
    where either is missing."""
    off = rec["spans"].of("issue", traced=False)
    on = rec["spans"].of("issue", traced=True)
    if ms is None or not off or not on or sum(on) <= 0:
        return None
    return ms * (sum(off) / len(off)) / (sum(on) / len(on))


def stage_roofline(rec: dict, name: str, work_s):
    """100 x a stage's least time (``work_s(fields, c, n)``) over the mean
    device time of its spans, in %."""
    ms = device_ms(rec, name)
    if not ms:
        return None
    return 100.0 * work_s(rec["fields"], rec["channels"],
                          rec["samples"]) / (ms * 1e-3)
