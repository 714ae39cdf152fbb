"""host_ms_per_call.throughput: the host's own time in a call into the entry
point, in ms: the mean of the spans around the calls a traced run makes after
its window with the device drained before each, so that a full launch queue
cannot stretch them (inside the window the queue holds a device-bound loop
back). Host clock."""

from h100bench.readers import drained_call_ms as read  # noqa: F401
