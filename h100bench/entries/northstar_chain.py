"""How the benchmark drives the ``northstar_chain`` configuration: the
offline chain (``NorthStarChain``) for closed loops and the live stream
(``StreamingNorthStar``) for open ones, both built from the fields."""

from __future__ import annotations

from vv_dsp_tpu_torch.models import NorthStarChain, StreamingNorthStar

CHAIN = ("fir_taps", "fir_cutoff", "up", "down", "nfft", "hop", "n_mels",
         "n_mfcc", "sample_rate", "window")


def call(fields: dict, device):
    """(c, n) clips -> (c, frames, n_mfcc) MFCCs."""
    return NorthStarChain(**{k: fields[k] for k in CHAIN},
                          fused_head=fields["fused_head"],
                          head_algorithm=fields["head_algorithm"],
                          stft_algorithm=fields["stft_algorithm"],
                          device=device)


def stream(fields: dict, device):
    """init(channels) -> state; step(state, (c, block)) -> (frames,
    state)."""
    s = StreamingNorthStar(**{k: fields[k] for k in CHAIN})
    return (lambda channels: s.init((channels,), device=device)), s.process
