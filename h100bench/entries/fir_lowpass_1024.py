"""How the benchmark drives the ``fir_lowpass_1024`` configuration: the
call a user of the torch API writes, ``fir_apply_best(h, x)`` with the
taps designed once on the device by ``design_lowpass`` and held on the
host, where a caller keeps a filter it designed once. Taps held on the
card give the same bits; the route reads them back once per tensor
(``filter_kernels._host_taps``), so they time the same kernel, but a
route that reads them back every call drains the stream each call and
its throughput then follows the host's load. No ``prepare``: the pool's
rows are the input."""

from __future__ import annotations

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops.filter_kernels import fir_apply_best
from vv_dsp_tpu_torch.ops.fir import design_lowpass

# the matmul-precision setting under which the banded route runs each tier
PRECISION = {"f32": "highest", "bf16x3": "high", "bf16": "default"}


def call(fields: dict, device):
    """(c, n) -> (c, n) float32 filtered rows, lfilter(h, [1], x), at the
    fields' tier: the plain call where the knob's setting already gives
    it, as for the configuration's f32; under ``config.matmul_precision``
    otherwise, as for the control's bf16x3."""
    h = design_lowpass(fields["fir_taps"], fields["fir_cutoff"],
                       fields["window"], device=device).cpu()
    tier = fields["algorithm"]
    if config.dot_algorithm(None) == tier:
        return lambda x: fir_apply_best(h, x)

    def at_tier(x):
        with config.matmul_precision(PRECISION[tier]):
            return fir_apply_best(h, x)
    return at_tier
