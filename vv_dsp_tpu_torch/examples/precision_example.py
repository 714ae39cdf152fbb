"""Accuracy/throughput knob (counterpart of examples/precision_example.py
and of the reference's examples/fastapprox_example.c): the matmul
precision tiers, switched at runtime with ``config.set_matmul_precision``,
set the tier of every contraction whose caller names none, here the mel
and DCT products of MFCCFrontend's packed MFCC kernel. Prints the error
each tier introduces on the MFCC front-end against "highest".

    python -m vv_dsp_tpu_torch.examples.precision_example [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.examples import parse
from vv_dsp_tpu_torch.models import MFCCFrontend

TIERS = ("highest", "high", "default")


def run(device) -> dict:
    print("vv-dsp-tpu precision-knob example (PyTorch port)")
    print("=================================\n")
    print("Available accuracy tiers (config.set_matmul_precision):")
    print("- highest: six bf16 products, f32 parity (the default contract)")
    print("- high:    three bf16 products, bf16x3 (~1e-5 rel err)")
    print("- default: one bf16 product (~1e-3 rel err, fastest)\n")

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((1, 48000)), dtype=torch.float32,
                        device=device)
    frontend = MFCCFrontend(device=device)

    previous = config.get_matmul_precision()
    errors = {}
    try:
        config.set_matmul_precision("highest")
        ref = frontend(x).cpu().double().numpy()
        for tier in TIERS:
            config.set_matmul_precision(tier)
            out = frontend(x).cpu().double().numpy()
            err = np.abs(out - ref).max() / np.abs(ref).max()
            errors[tier] = float(err)
            print(f"MFCC @ {tier:8s}: max rel err vs highest = {err:.2e}")
    finally:
        config.set_matmul_precision(previous)
    return {"errors": errors, "ref": ref}


def main(argv=None) -> int:
    _, dev = parse(argv, __doc__)
    if dev is None:
        return 1
    run(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
