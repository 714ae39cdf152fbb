"""STFT spectral-gate denoising pipeline (counterpart of
examples/stft_pipeline_example.py and of the reference's
bench/bench_pipeline.c chain): noisy sine -> STFT -> magnitude gate ->
ISTFT, on SpectralGate(1024, 256, 0.1), which runs the packed spectrum
kernel and the gated packed inverse on the card.

    python -m vv_dsp_tpu_torch.examples.stft_pipeline_example [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from vv_dsp_tpu_torch.examples import parse
from vv_dsp_tpu_torch.models import SpectralGate


def run(device) -> dict:
    fs, n = 48000, 48000
    t = np.arange(n) / fs
    clean = 0.8 * np.sin(2 * np.pi * 440.0 * t)
    noisy = clean + 0.05 * np.random.default_rng(0).standard_normal(n)
    x = torch.as_tensor(noisy[None, :], dtype=torch.float32, device=device)

    gate = SpectralGate(nfft=1024, hop=256, threshold=0.1, device=device)
    out = gate(x)[0].cpu().numpy()

    seg = slice(1024, n - 1024)
    snr_in = 10 * np.log10(np.mean(clean[seg] ** 2)
                           / np.mean((noisy[seg] - clean[seg]) ** 2))
    snr_out = 10 * np.log10(np.mean(clean[seg] ** 2)
                            / np.mean((out[seg] - clean[seg]) ** 2))
    print(f"SNR in: {snr_in:.1f} dB -> out: {snr_out:.1f} dB")
    return {"snr_in": float(snr_in), "snr_out": float(snr_out), "y": out}


def main(argv=None) -> int:
    _, dev = parse(argv, __doc__)
    if dev is None:
        return 1
    run(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
