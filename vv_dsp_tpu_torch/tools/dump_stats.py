"""Stats dump (counterpart of vv_dsp_tpu/tools/dump_stats.py, parity with
tools/dump_stats.c): reads n values from STDIN, 'autocorr <n> [biased]'
prints lags 0..n-1 at %.17g."""

from __future__ import annotations

import sys

import numpy as np
import torch

from vv_dsp_tpu_torch.ops import stats
from vv_dsp_tpu_torch.tools import _cli


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        sys.stderr.write("usage: dump_stats autocorr <n> [biased] [--cpu]\n")
        return 2
    cmd, n = argv[0], int(argv[1])
    vals = []
    for tok in sys.stdin.read().split():
        vals.append(float(tok))
        if len(vals) >= n:
            break
    if len(vals) < n:
        return 4
    x = np.asarray(vals, dtype=np.float32)
    if cmd == "autocorr":
        biased = bool(int(argv[2])) if len(argv) >= 3 else True
        dev = _cli.open_device(device)
        if dev is None:
            return 1
        r = stats.autocorrelation(torch.as_tensor(x, device=dev), n - 1,
                                  biased=biased)
        _cli.print_reals(r, "%.17g")
        return 0
    sys.stderr.write("unknown command\n")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
