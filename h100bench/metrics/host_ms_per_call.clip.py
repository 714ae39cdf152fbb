"""host_ms_per_call.clip: host_ms_per_call.throughput's arithmetic, in the
cells that clip_throughput_msps measures. Host clock."""

from h100bench.readers import drained_call_ms as read  # noqa: F401
