"""entry_self_ms_per_call.clip: the self time (ms) of ``STFT.process`` a
call: its ``stft`` root span less the spans inside it (the kernel
wrapper's), averaged over the calls of the traced stretch and scaled by
the run's untraced over traced calls (``h100bench/inside.py``). What
remains is the entry point's own host work: the input's conversion, the
window lookup, the route and the autograd shim's closures. Host clock.
The scale takes the profiler's cost out evenly, though it falls unevenly
between entry and wrapper: compare this metric between runs, not with
``host_ms_per_call.clip``."""

from h100bench import inside


def read(rec: dict):
    return inside.untraced(rec, inside.self_ms(rec, "stft"))
