"""STFT->ISTFT roundtrip dump (counterpart of
vv_dsp_tpu/tools/dump_stft_roundtrip.py, parity with
tools/dump_stft_roundtrip.c): frames iterate only while f*hop+fft <= n (no
zero-padded tail), OLA with w^2 norm, per-sample y = recon/norm if
norm > 1e-12 else 0, exactly n lines."""

from __future__ import annotations

import sys

import torch

from vv_dsp_tpu_torch.ops import fft as _offt
from vv_dsp_tpu_torch.ops import framing
from vv_dsp_tpu_torch.ops.window import get_window
from vv_dsp_tpu_torch.tools import _cli

USAGE = ("Usage: dump_stft_roundtrip --fft N --hop H"
         " --win hann|hamming|boxcar --n SAMPLES [--infile PATH]"
         " [--seed SEED] [--cpu]")

SPEC = {"--fft": ("fft", int), "--hop": ("hop", int), "--win": ("win", str),
        "--n": ("n", int), "--seed": ("seed", int), "--infile": ("infile", str)}


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    args = _cli.parse_flags(argv, SPEC, USAGE)
    if args is None:
        return 2
    nfft = args.get("fft", 256)
    hop = args.get("hop", 128)
    win = args.get("win", "hann")
    n = args.get("n", 2048)
    if win not in ("hann", "hamming", "boxcar"):
        sys.stderr.write(USAGE + "\n")
        return 2
    infile = args.get("infile")
    dev = _cli.open_device(device)
    if dev is None:
        return 1

    x = (_cli.read_reals(infile, n) if infile
         else _cli.rand_reals(n, args.get("seed", 0)))
    sig = torch.as_tensor(x, device=dev)
    w = get_window(win, nfft, device=dev)
    nf = 0 if n < nfft else (n - nfft) // hop + 1  # f*hop+fft <= n
    idx = (torch.arange(nf, device=dev)[:, None] * hop
           + torch.arange(nfft, device=dev)[None, :])
    frames = sig[..., idx] * w
    time = frames
    if nf:  # no frame: nothing to transform (an empty FFT plan raises)
        spec = _offt.fft(frames)  # fwd C2C like the reference STFT
        time = _offt.ifft(spec).real * w
    recon = framing.overlap_add(time, hop, n)
    norm = framing.overlap_add((w * w).expand(nf, nfft), hop, n)
    ok = norm > 1e-12
    y = torch.where(ok, recon / torch.where(ok, norm, 1.0), 0.0)
    _cli.print_reals(y)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
