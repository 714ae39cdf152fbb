"""Resampler dump (counterpart of vv_dsp_tpu/tools/dump_resample.py, parity
with tools/dump_resample.c): linear or sinc[:taps] quality, output length
floor((n-1)*num/den)+1. With --infile, n is the line count of the file
(like the reference's line-counting loop)."""

from __future__ import annotations

import sys

import torch

from vv_dsp_tpu_torch.ops import resample
from vv_dsp_tpu_torch.tools import _cli

USAGE = ("Usage: dump_resample --num NUM --den DEN"
         " --quality linear|sinc[:taps] --n IN_SAMPLES --seed SEED"
         " [--infile PATH] [--cpu]")

SPEC = {"--num": ("num", int), "--den": ("den", int),
        "--quality": ("quality", str), "--n": ("n", int),
        "--seed": ("seed", int), "--infile": ("infile", str)}


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    args = _cli.parse_flags(argv, SPEC, USAGE)
    if args is None:
        return 2
    num = args.get("num", 2)
    den = args.get("den", 1)
    qual = args.get("quality", "linear")
    taps = 32
    if ":" in qual:
        qual, taps_s = qual.split(":", 1)
        taps = int(taps_s)
    dev = _cli.open_device(device)
    if dev is None:
        return 1

    infile = args.get("infile")
    if infile:
        x = _cli.read_reals(infile)
    else:
        x = _cli.rand_reals(args.get("n", 256), args.get("seed", 0))
    xt = torch.as_tensor(x, device=dev)
    if qual.startswith("sinc"):
        y = resample.resample_sinc(xt, num, den, taps)
    else:
        y = resample.resample_linear(xt, num, den)
    _cli.print_reals(y)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
