"""DCT dump (counterpart of vv_dsp_tpu/tools/dump_dct.py, parity with
tools/dump_dct.c): DCT-II/III/IV fwd/inv with the reference's scaling (fwd
unscaled, inverse x2/N; src/spectral/dct.c:18-68). Default input without
--infile is i % 7."""

from __future__ import annotations

import sys

import numpy as np
import torch

from vv_dsp_tpu_torch.ops import dct
from vv_dsp_tpu_torch.tools import _cli

USAGE = ("Usage: dump_dct --type 2|3|4 --dir fwd|inv -n N [--infile path]"
         " [--cpu]")

SPEC = {"--type": ("type", int), "--dir": ("dir", str), "-n": ("n", int),
        "--infile": ("infile", str)}


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    args = _cli.parse_flags(argv, SPEC, USAGE)
    if args is None:
        return 2
    typ = args.get("type", 2)
    n = args.get("n", 8)
    inverse = args.get("dir", "fwd") != "fwd"
    if typ not in (2, 3, 4):
        sys.stderr.write(USAGE + "\n")
        return 2
    dev = _cli.open_device(device)
    if dev is None:
        return 1

    infile = args.get("infile")
    if infile:
        x = _cli.read_reals(infile, n)
    else:
        x = (np.arange(n) % 7).astype(np.float32)
    _cli.print_reals(dct.dct(torch.as_tensor(x, device=dev), type=typ,
                             inverse=inverse))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
