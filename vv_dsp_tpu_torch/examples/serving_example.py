"""Serving-ingest pattern: batch WAV decode overlapped with the card's
compute (counterpart of examples/serving_example.py): many audio streams
a step, host decode running ahead of the device via ``prefetch_batches``,
MFCC features out (MFCCFrontend(1024, 256, 40 mels, 13 MFCCs, 48 kHz), the
packed MFCC kernel on the card).

    python -m vv_dsp_tpu_torch.examples.serving_example [--cpu]
        [--files 64] [--seconds 2.0]

The first batch's shape is run once before the loop, so the loop measures
steady-state serving; the rate is wall time, decode overlapped.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from vv_dsp_tpu_torch.examples import parse
from vv_dsp_tpu_torch.io import prefetch_batches, write_wav
from vv_dsp_tpu_torch.models import MFCCFrontend

BATCH = 16
SAMPLE_RATE = 48000


def make_corpus(root: str, n_files: int, seconds: float, sr: int) -> list:
    rng = np.random.default_rng(0)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    paths = []
    for i in range(n_files):
        f0 = 200.0 + 50.0 * i
        x = (0.4 * np.sin(2 * np.pi * f0 * t)
             + 0.02 * rng.standard_normal(n)).astype(np.float32)
        p = os.path.join(root, f"stream{i:03d}.wav")
        write_wav(p, x, sr, format=16)
        paths.append(p)
    return paths


def run(device, files: int = 64, seconds: float = 2.0) -> dict:
    sr = SAMPLE_RATE
    model = MFCCFrontend(nfft=1024, hop=256, n_mels=40, n_mfcc=13,
                         sample_rate=float(sr), device=device)
    cap = int(seconds * sr)
    feats_all = []
    with tempfile.TemporaryDirectory(prefix="vvdsp_serving_") as root:
        paths = make_corpus(root, files, seconds, sr)
        chunks = [paths[i:i + BATCH] for i in range(0, len(paths), BATCH)]
        # the first batch's shape, so the loop below measures steady state
        model(torch.zeros((len(chunks[0]), cap), device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

        total_samples = 0
        t0 = time.perf_counter()
        for batch in prefetch_batches(chunks, capacity_frames=cap,
                                      channels=1):
            if not batch.ok:
                bad = [p for p, f in zip(batch.paths, batch.frames) if f < 0]
                raise RuntimeError(f"undecodable inputs: {bad}")
            feats = model(batch.data[:, 0, :].to(device)).cpu().numpy()
            feats_all.append(feats)
            total_samples += int(batch.frames.sum())
            print(f"batch of {len(batch.paths)}: features {feats.shape}")
        dt = time.perf_counter() - t0
    print(f"served {total_samples} samples in {dt:.2f}s "
          f"({total_samples / dt / 1e6:.0f} Msamples/s end-to-end, "
          f"decode overlapped) on {device.type}")
    return {"feats": feats_all, "samples": total_samples, "seconds": dt}


def main(argv=None) -> int:
    def sizes(ap):
        ap.add_argument("--files", type=int, default=64)
        ap.add_argument("--seconds", type=float, default=2.0)

    args, dev = parse(argv, __doc__, sizes)
    if dev is None:
        return 1
    run(dev, args.files, args.seconds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
