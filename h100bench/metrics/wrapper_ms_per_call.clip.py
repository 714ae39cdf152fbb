"""wrapper_ms_per_call.clip: the host ms a call spends in the port's
kernel wrappers (the ``kernel.<wrapper>`` spans: validation, tables, the
output's allocation, the pointers and the ctypes launch), summed over a
call and averaged over the ``stft`` calls of the traced stretch, scaled by
the run's untraced over traced calls (``h100bench/inside.py``). Host
clock. The profiler's cost, which the scale takes out evenly, falls on the
wrapper's launch and allocation more than on the entry's Python, so this
is not the wrapper's untraced time: compare it between runs, not with
``host_ms_per_call.clip``."""

from h100bench import inside


def read(rec: dict):
    return inside.untraced(
        rec, inside.prefixed_ms_per_call(rec, "kernel.", "stft"))
