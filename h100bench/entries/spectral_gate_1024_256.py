"""How the benchmark drives the ``spectral_gate_1024_256`` configuration:
``SpectralGate(nfft, hop, threshold, window)``, the class users call, on
its own route; each pool input prepared once, in set-up, into the
reference's tone probe."""

from __future__ import annotations

from h100bench.reference.spectral_gate_1024_256 import probe
from vv_dsp_tpu_torch.models import SpectralGate


def prepare(fields: dict, x):
    """(c, n) N(0, 1) rows -> the (c, n) float32 probe rows the reference
    gates, bit for bit."""
    return probe(fields, x)


def call(fields: dict, device):
    """(c, n) -> (c, n) float32 gated rows."""
    return SpectralGate(fields["nfft"], fields["hop"], fields["threshold"],
                        fields["window"], device=device)
