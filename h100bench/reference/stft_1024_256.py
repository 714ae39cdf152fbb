"""Plain float64 reference of the ``stft_1024_256`` configuration: the
two-sided complex spectrum of non-centred Hann frames, the last frame
zero-padded, unscaled forward FFT. Imports numpy, torch and the
reference's own ``common`` only.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.reference import common as C

# err_of_scale: max |got - want| / max |want| over every bin of an answer
# (the readings it was set from are in PERF.md).
LIMITS = {"call": {"err_of_scale": 1e-4}}

# The spectrum is float32 arithmetic outside the tensor cores, and the
# program has no lower-precision path of its own: the control is this
# reference in bfloat16, a tensor-core DFT of bf16 frames and basis.
CONTROL = {"call": {"kind": "reference"}}


def _geometry(fields: dict, n: int):
    nfft, hop = fields["nfft"], fields["hop"]
    return nfft, hop, C.num_frames(n, nfft, hop)


def call(fields: dict, x: torch.Tensor) -> torch.Tensor:
    """(c, n) -> (c, frames, nfft) complex128."""
    nfft, hop, nf = _geometry(fields, x.shape[-1])
    win = torch.as_tensor(C.window(fields["window"], nfft), device=x.device)
    return torch.fft.fft(C.frames(x.double(), nfft, hop, nf) * win)


def control_call(fields: dict, x: torch.Tensor) -> torch.Tensor:
    """The same spectrum in bfloat16: windowed frames and the DFT basis
    rounded to bf16, products accumulated in float32, the bins rounded to
    bf16."""
    nfft, hop, nf = _geometry(fields, x.shape[-1])
    dev = x.device
    win = torch.as_tensor(C.window(fields["window"], nfft), device=dev,
                          dtype=torch.float32)
    fr = (C.frames(x.float(), nfft, hop, nf) * win).to(torch.bfloat16)
    k = np.arange(nfft)
    ang = -2.0 * np.pi * np.outer(k, k) / nfft
    cos = torch.as_tensor(np.cos(ang), device=dev).to(torch.bfloat16)
    sin = torch.as_tensor(np.sin(ang), device=dev).to(torch.bfloat16)
    return torch.complex((fr @ cos).float(), (fr @ sin).float())
