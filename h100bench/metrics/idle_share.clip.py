"""idle_share.clip: idle_share.throughput's arithmetic, in the cells that
clip_throughput_msps measures. From the torch.profiler trace."""

from h100bench.readers import idle_share as read  # noqa: F401
