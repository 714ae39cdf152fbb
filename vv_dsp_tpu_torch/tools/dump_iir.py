"""Single-biquad dump tool (counterpart of vv_dsp_tpu/tools/dump_iir.py,
parity with tools/dump_iir.c, including its scipy-sign convention: output
equals scipy.signal.lfilter([b0,b1,b2], [1,-a1,-a2], x); the tool negates
a1/a2 exactly as dump_iir.c:24-26)."""

from __future__ import annotations

import sys

import torch

from vv_dsp_tpu_torch.ops import iir
from vv_dsp_tpu_torch.tools import _cli

USAGE = ("Usage: dump_iir --b0 B0 --b1 B1 --b2 B2 --a1 A1 --a2 A2 --n SAMPLES"
         " --seed SEED [--infile PATH] [--cpu]")

SPEC = {"--b0": ("b0", float), "--b1": ("b1", float), "--b2": ("b2", float),
        "--a1": ("a1", float), "--a2": ("a2", float), "--n": ("n", int),
        "--seed": ("seed", int), "--infile": ("infile", str)}


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    args = _cli.parse_flags(argv, SPEC, USAGE)
    if args is None:
        return 2
    n = args.get("n", 128)
    infile = args.get("infile")
    dev = _cli.open_device(device)
    if dev is None:
        return 1

    x = (_cli.read_reals(infile, n) if infile
         else _cli.rand_reals(n, args.get("seed", 0)))
    # lfilter(b, [1, -a1, -a2]) convention == our DF2T with a1' = -a1,
    # a2' = -a2
    y = iir.biquad_apply(torch.as_tensor(x, device=dev), args.get("b0", 1.0),
                         args.get("b1", 0.0), args.get("b2", 0.0),
                         -args.get("a1", 0.0), -args.get("a2", 0.0))
    _cli.print_reals(y)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
