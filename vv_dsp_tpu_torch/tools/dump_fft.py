"""FFT dump tool (counterpart of vv_dsp_tpu/tools/dump_fft.py, parity with
tools/dump_fft.c:11-98): c2c/r2c/c2r x fwd/inv on text fixtures,
'%g,%g' / '%g' stdout."""

from __future__ import annotations

import sys

import torch

from vv_dsp_tpu_torch.ops import fft as F
from vv_dsp_tpu_torch.tools import _cli

USAGE = ("Usage: dump_fft --type c2c|r2c|c2r --dir fwd|inv -n N --seed S"
         " [--infile PATH] [--cpu]")

SPEC = {
    "-n": ("n", int), "--type": ("type", str), "--dir": ("dir", str),
    "--seed": ("seed", int), "--infile": ("infile", str),
}


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    args = _cli.parse_flags(argv, SPEC, USAGE)
    if args is None:
        return 2
    n = args.get("n", 16)
    typ = args.get("type", "c2c")
    fwd = args.get("dir", "fwd") == "fwd"
    seed = args.get("seed", 0)
    infile = args.get("infile")
    if typ not in ("c2c", "r2c", "c2r"):
        sys.stderr.write(USAGE + "\n")
        return 2
    dev = _cli.open_device(device)
    if dev is None:
        return 1

    if typ == "c2c":
        x = (_cli.read_complex(infile, n) if infile
             else _cli.rand_complex(n, seed))
        x = torch.as_tensor(x, device=dev)
        _cli.print_complex(F.fft(x) if fwd else F.ifft(x))
    elif typ == "r2c":
        x = (_cli.read_reals(infile, n) if infile else
             _cli.rand_reals(n, seed, 0.0, 1.0))
        _cli.print_complex(F.rfft(torch.as_tensor(x, device=dev)))
    else:  # c2r: m = n//2+1 bins in, n reals out (inverse, 1/n scaled)
        m = n // 2 + 1
        x = (_cli.read_complex(infile, m) if infile
             else _cli.rand_complex(m, seed))
        _cli.print_reals(F.irfft(torch.as_tensor(x, device=dev), n))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
