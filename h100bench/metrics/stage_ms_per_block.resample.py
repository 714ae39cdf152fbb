"""stage_ms_per_block.resample: the mean host time (ms) a block of the
program's ``stream.resample`` span, the polyphase resampler's
step (``ResamplePolyStream.process``), inside ``StreamingNorthStar.process``,
over the blocks of the traced stretch, scaled by the run's untraced over
traced calls (``inside.untraced``), so the four stages sum to about an
untraced block. Host clock. The profiler's cost, which the scale takes
out evenly, falls on each stage by its PyTorch operations, so the split
among the stages leans toward the steps with many operations: compare
this metric between runs, not with ``host_ms_per_block.latency``."""

from h100bench import inside


def read(rec: dict):
    return inside.untraced(rec, inside.host_ms(rec, "stream.resample"))
