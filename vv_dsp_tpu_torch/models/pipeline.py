"""The north-star DSP chain as an ``nn.Module`` (counterpart of
``vv_dsp_tpu/models/pipeline.py::NorthStarChain``).

1024-tap FIR -> 4/3 polyphase resample (one fused banded upfirdn, kernel 1)
-> 2048/512 STFT -> 80 HTK mel bands -> log -> 20 MFCCs (one fused kernel,
kernel 2). The module's buffers are the device constants: the composite
head filter's polyphase table, the window, the mel filterbank with its
band edges and the liftered DCT rows. ``chain_params`` builds them on the
host in float64; ``convert.params_from_reference`` carries the JAX
chain's arrays across.

The JAX chain hands the head's raw segment tiles to the STFT kernel on the
TPU to skip two transposes; here the head writes natural (c, n_out) order,
which is what the MFCC kernel reads, so the chain runs the two kernels
back to back (the same numbers).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import fir as _fir
from vv_dsp_tpu_torch.ops import mel as _mel
from vv_dsp_tpu_torch.ops import resample as _rs
from vv_dsp_tpu_torch.ops.stft_kernels import band_edges_np
from vv_dsp_tpu_torch.ops.upfirdn import polyphase_table_np
from vv_dsp_tpu_torch.ops.window import get_window_np


def chain_params(fir_taps: int = 1024, fir_cutoff: float = 0.45, up: int = 4,
                 down: int = 3, nfft: int = 2048, n_mels: int = 80,
                 n_mfcc: int = 20, sample_rate: float = 48000.0,
                 window: str = "hann") -> dict:
    """The chain's host constants, as numpy arrays: fir_coeffs (float32, as
    the JAX chain keeps them), the composite head filter g (float64) and
    its offset, the window, the mel filterbank at the output rate and the
    DCT-II rows (float64)."""
    fir = _fir.design_lowpass_np(fir_taps, fir_cutoff).astype(np.float32)
    gcd = math.gcd(up, down)
    g, offset = _rs._fused_fir_resample_filter(
        tuple(fir.astype(np.float64)), up // gcd, down // gcd)
    sr = sample_rate * up / down
    return {
        "fir_coeffs": fir,
        "g": g,
        "offset": offset,
        "window": get_window_np(window, nfft),
        "mel_fb": _mel.mel_filterbank_np(nfft, n_mels, float(sr), 0.0,
                                         float(sr) / 2.0, "htk"),
        "dct_lift": _mel.mfcc_dct_np(n_mels, n_mfcc, 0.0),
    }


class NorthStarChain(nn.Module):
    """1024-tap FIR -> up/down polyphase resample -> STFT -> log-mel -> MFCC.

    Same fields and defaults as the JAX chain. head_algorithm and
    stft_algorithm name the dot-algorithm tier of the banded head and of
    the mel/DCT contractions ("bf16x3" by default, as in the JAX chain;
    "f32" for full float32). params: host constants from ``chain_params``
    or ``convert.params_from_reference``; built from the fields when None.
    """

    def __init__(self, fir_taps: int = 1024, fir_cutoff: float = 0.45,
                 up: int = 4, down: int = 3, nfft: int = 2048, hop: int = 512,
                 n_mels: int = 80, n_mfcc: int = 20,
                 sample_rate: float = 48000.0, window: str = "hann",
                 fused_head: bool = True,
                 head_algorithm: str | None = "bf16x3",
                 stft_algorithm: str | None = "bf16x3",
                 params: dict | None = None):
        super().__init__()
        if not fused_head:
            raise NotImplementedError(
                "fused_head=False (the separate FIR and resample kernels) is "
                "not ported yet")
        self.fir_taps, self.fir_cutoff = fir_taps, fir_cutoff
        self.up, self.down = up, down
        self.nfft, self.hop = nfft, hop
        self.n_mels, self.n_mfcc = n_mels, n_mfcc
        self.sample_rate, self.window_name = sample_rate, window
        self.fused_head = fused_head
        self.head_algorithm = head_algorithm
        self.stft_algorithm = stft_algorithm
        if params is None:
            params = chain_params(fir_taps, fir_cutoff, up, down, nfft, n_mels,
                                  n_mfcc, sample_rate, window)
        # host copy: the staged tail correction is built from it per length
        self.fir_coeffs = np.asarray(params["fir_coeffs"])

        def buf(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32))

        up_r = up // math.gcd(up, down)
        self.register_buffer("head_taps",
                             buf(polyphase_table_np(params["g"], up_r)))
        self.register_buffer("window", buf(params["window"]))
        self.register_buffer("mel_fb", buf(params["mel_fb"]))
        self.register_buffer("mel_bands", torch.as_tensor(
            band_edges_np(params["mel_fb"])))
        self.register_buffer("dct_lift", buf(params["dct_lift"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (channels, n) -> (channels, frames, n_mfcc)."""
        x = config.as_compute(x)
        y = _rs.fir_resample_fused(self.fir_coeffs, x, self.up, self.down,
                                   algorithm=self.head_algorithm,
                                   taps=self.head_taps)
        return _mel.mfcc_stft_with(y, self.nfft, self.hop, self.window,
                                   self.mel_fb, self.mel_bands,
                                   self.dct_lift, 1e-10,
                                   self.stft_algorithm)
