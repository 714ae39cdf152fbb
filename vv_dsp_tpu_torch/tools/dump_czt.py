"""CZT dump (counterpart of vv_dsp_tpu/tools/dump_czt.py, parity with
tools/dump_czt.c): SciPy-convention chirp-Z at M points, W/A given as
re/im pairs, real input by default (--complex for 're,im' fixtures),
output '%.8g,%.8g'."""

from __future__ import annotations

import sys

import torch

from vv_dsp_tpu_torch.ops import czt
from vv_dsp_tpu_torch.tools import _cli

USAGE = ("Usage: dump_czt --N <N> --M <M> --Wre <wre> --Wim <wim> --Are <are>"
         " --Aim <aim> --infile <path> [--complex] [--cpu]")

SPEC = {"--N": ("N", int), "--M": ("M", int), "--Wre": ("wre", float),
        "--Wim": ("wim", float), "--Are": ("are", float),
        "--Aim": ("aim", float), "--infile": ("infile", str),
        "--complex": ("complex", bool)}


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    args = _cli.parse_flags(argv, SPEC, USAGE)
    if args is None:
        return 2
    n = args.get("N", 0)
    m = args.get("M", 0)
    infile = args.get("infile")
    if n == 0 or m == 0 or not infile:
        sys.stderr.write(USAGE + "\n")
        return 2
    w = complex(args.get("wre", 0.0), args.get("wim", 0.0))
    a = complex(args.get("are", 1.0), args.get("aim", 0.0))
    dev = _cli.open_device(device)
    if dev is None:
        return 1

    if args.get("complex"):
        x = _cli.read_complex(infile, n)
    else:
        x = _cli.read_reals(infile, n)
    out = czt.czt(torch.as_tensor(x, device=dev), m, w, a)
    _cli.print_complex(out, "%.8g,%.8g")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
