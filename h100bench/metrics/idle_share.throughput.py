"""idle_share.throughput: the device's idle share over the traced stretch,
1 - (union of kernel, memcpy and memset intervals) / stretch length, in %.
From the torch.profiler trace."""

from h100bench.readers import idle_share as read  # noqa: F401
