"""throughput_msps: input samples of every call completed in the window
(calls x channels x samples a channel), over the window's wall time, in
millions a second. The window ends with a synchronise, so each call counted
has its whole output on the device. Host clock."""

from h100bench.readers import rate_msps as read  # noqa: F401
