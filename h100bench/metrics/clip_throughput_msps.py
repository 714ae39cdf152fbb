"""clip_throughput_msps: throughput_msps's arithmetic, for a loop of small
calls whose host work dominates. Kept apart from throughput_msps because one
bound serves every cell of a metric, and these runs spread 60-80x wider than
the device-bound cells'. Host clock."""

from h100bench.readers import rate_msps as read  # noqa: F401
