"""FIR design+apply dump tool (counterpart of vv_dsp_tpu/tools/dump_fir.py,
parity with tools/dump_fir.c)."""

from __future__ import annotations

import sys

import torch

from vv_dsp_tpu_torch.ops import fir
from vv_dsp_tpu_torch.tools import _cli

USAGE = ("Usage: dump_fir --num-taps N --cutoff C --win hann|hamming|boxcar"
         " --n SAMPLES --seed SEED [--infile PATH] [--dump-coeffs PATH]"
         " [--cpu]")

SPEC = {
    "--num-taps": ("taps", int), "--cutoff": ("cutoff", float),
    "--win": ("win", str), "--n": ("n", int), "--seed": ("seed", int),
    "--infile": ("infile", str), "--dump-coeffs": ("dump_coeffs", str),
}

WIN_MAP = {"hann": "hann", "hanning": "hann", "hamming": "hamming",
           "boxcar": "boxcar", "blackman": "blackman"}


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    args = _cli.parse_flags(argv, SPEC, USAGE)
    if args is None:
        return 2
    taps = args.get("taps", 31)
    cutoff = args.get("cutoff", 0.25)
    win = WIN_MAP.get(args.get("win", "hamming"))
    n = args.get("n", 256)
    if win is None:
        sys.stderr.write(USAGE + "\n")
        return 2
    dev = _cli.open_device(device)
    if dev is None:
        return 1

    h = fir.design_lowpass(taps, cutoff, win, device=dev)
    if "dump_coeffs" in args:
        with open(args["dump_coeffs"], "w") as f:
            for v in _cli.host(h):
                f.write("%g\n" % float(v))
    infile = args.get("infile")
    x = (_cli.read_reals(infile, n) if infile
         else _cli.rand_reals(n, args.get("seed", 0)))
    _cli.print_reals(fir.fir_apply(h, torch.as_tensor(x, device=dev)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
