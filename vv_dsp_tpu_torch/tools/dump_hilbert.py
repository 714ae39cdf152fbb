"""Hilbert dump (counterpart of vv_dsp_tpu/tools/dump_hilbert.py, parity
with tools/dump_hilbert.c): generates sin(2*pi*f0*t/fs + phase), prints the
analytic signal 're,im' per line plus an avg_ifreq sanity line on
stderr."""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from vv_dsp_tpu_torch.ops import hilbert
from vv_dsp_tpu_torch.tools import _cli

USAGE = "Usage: dump_hilbert -n N --fs FS --f F0 --phase PHASE [--cpu]"

SPEC = {"-n": ("n", int), "--fs": ("fs", float), "--f": ("f0", float),
        "--phase": ("phase", float)}


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    args = _cli.parse_flags(argv, SPEC, USAGE)
    if args is None:
        return 2
    n = args.get("n", 256)
    fs = args.get("fs", 1000.0)
    f0 = args.get("f0", 123.0)
    ph = args.get("phase", 0.0)
    dev = _cli.open_device(device)
    if dev is None:
        return 1

    t = np.arange(n, dtype=np.float64)
    x = torch.as_tensor(np.sin(2.0 * math.pi * f0 * t / fs + ph),
                        dtype=torch.float32, device=dev)
    xa = hilbert.hilbert_analytic(x)
    phi = hilbert.instantaneous_phase(xa)
    freq = hilbert.instantaneous_frequency(phi, fs)
    avg = float(np.mean(_cli.host(freq)[1:]))
    sys.stderr.write("avg_ifreq=%g Hz manual=%g\n" % (avg, avg))
    _cli.print_complex(xa)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
