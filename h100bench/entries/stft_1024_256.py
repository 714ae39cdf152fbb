"""How the benchmark drives the ``stft_1024_256`` configuration: the
two-sided complex spectrum, ``STFT(nfft, hop, window).process(x,
rfft=False)``."""

from __future__ import annotations

from vv_dsp_tpu_torch.ops.stft import STFT


def call(fields: dict, device):
    """(c, n) -> (c, frames, nfft) complex64."""
    stft = STFT(fields["nfft"], fields["hop"], fields["window"])
    return lambda x: stft.process(x, rfft=False)
