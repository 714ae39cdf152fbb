"""MFCC dump (counterpart of vv_dsp_tpu/tools/dump_mfcc.py, parity with
tools/dump_mfcc.c:25-196): '#'-prefixed parameter header, synthetic
10-frame power spectrogram 1/(1+0.1k), MFCC rows at %.6f."""

from __future__ import annotations

import sys

import numpy as np
import torch

from vv_dsp_tpu_torch.ops import mel
from vv_dsp_tpu_torch.tools import _cli

USAGE = """Usage: dump_mfcc [options] [--cpu]
  --sample-rate RATE  Sample rate (default 16000)
  --n-fft N           FFT size (default 512)
  --hop-length N      Hop length (default 256)
  --n-mels N          Mel filters (default 26)
  --n-mfcc N          MFCC coefficients (default 13)
  --fmin F            Min frequency (default 0)
  --fmax F            Max frequency (default sample_rate/2)
  --lifter L          Liftering parameter (default 22)
  --output FILE       Output MFCC file (default: stdout)"""

SPEC = {"--sample-rate": ("sr", float), "--n-fft": ("n_fft", int),
        "--hop-length": ("hop", int), "--n-mels": ("n_mels", int),
        "--n-mfcc": ("n_mfcc", int), "--fmin": ("fmin", float),
        "--fmax": ("fmax", float), "--lifter": ("lifter", float),
        "--output": ("output", str)}


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    args = _cli.parse_flags(argv, SPEC, USAGE)
    if args is None:
        return 2
    sr = args.get("sr", 16000.0)
    n_fft = args.get("n_fft", 512)
    hop = args.get("hop", 256)
    n_mels = args.get("n_mels", 26)
    n_mfcc = args.get("n_mfcc", 13)
    fmin = args.get("fmin", 0.0)
    fmax = args.get("fmax", 0.0)
    lifter = args.get("lifter", 22.0)
    if fmax <= 0.0:
        fmax = sr / 2.0
    if n_mfcc > n_mels:
        sys.stderr.write("Error: n_mfcc cannot be larger than n_mels\n")
        return 1
    if fmin >= fmax:
        sys.stderr.write("Error: fmin must be less than fmax\n")
        return 1
    # before the header: a missing card writes nothing to stdout
    dev = _cli.open_device(device)
    if dev is None:
        return 1

    print("# MFCC parameters:")
    print("# sample_rate: %.1f" % sr)
    print("# n_fft: %d" % n_fft)
    print("# hop_length: %d" % hop)
    print("# n_mels: %d" % n_mels)
    print("# n_mfcc: %d" % n_mfcc)
    print("# fmin: %.1f" % fmin)
    print("# fmax: %.1f" % fmax)
    print("# lifter: %.1f" % lifter)

    n_bins = n_fft // 2 + 1
    num_frames = 10
    k = np.arange(n_bins, dtype=np.float32)
    power = np.tile(1.0 / (1.0 + 0.1 * k), (num_frames, 1))
    print("# Computed power spectrogram: %d frames x %d bins"
          % (num_frames, n_bins))

    coeffs = mel.mfcc(torch.as_tensor(power, dtype=torch.float32,
                                      device=dev),
                      n_fft, n_mels, n_mfcc, sr, fmin=fmin, fmax=fmax,
                      lifter=lifter)
    coeffs = _cli.host(coeffs)

    out_fp = sys.stdout
    close = False
    if "output" in args:
        out_fp = open(args["output"], "w")
        close = True
    out_fp.write("# MFCC coefficients (%d frames x %d coeffs)\n"
                 % (num_frames, n_mfcc))
    for row in coeffs:
        out_fp.write(" ".join("%.6f" % float(v) for v in row) + "\n")
    if close:
        out_fp.close()
    print("# Successfully computed %d frames of MFCC with %d coefficients each"
          % (num_frames, n_mfcc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
