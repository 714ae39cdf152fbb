"""FIR coefficient dump (counterpart of vv_dsp_tpu/tools/dump_fir_coeffs.py,
parity with tools/dump_fir_coeffs.c)."""

from __future__ import annotations

import sys

from vv_dsp_tpu_torch.ops import fir
from vv_dsp_tpu_torch.tools import _cli
from vv_dsp_tpu_torch.tools.dump_fir import WIN_MAP

USAGE = ("Usage: dump_fir_coeffs --num-taps N --cutoff C"
         " --win hann|hamming|boxcar|blackman [--cpu]")

SPEC = {"--num-taps": ("taps", int), "--cutoff": ("cutoff", float),
        "--win": ("win", str)}


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    args = _cli.parse_flags(argv, SPEC, USAGE)
    if args is None:
        return 2
    win = WIN_MAP.get(args.get("win", "hamming"))
    if win is None:
        sys.stderr.write(USAGE + "\n")
        return 2
    dev = _cli.open_device(device)
    if dev is None:
        return 1
    _cli.print_reals(fir.design_lowpass(args.get("taps", 31),
                                        args.get("cutoff", 0.25), win,
                                        device=dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
