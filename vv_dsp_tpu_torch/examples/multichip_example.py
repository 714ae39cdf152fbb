"""Sharded execution on a (channel, block) mesh (counterpart of
examples/multichip_example.py): a 1x8 mesh of the card repeated 8 times
(``[cuda:0] * 8``), or of the CPU with ``--cpu``; FIR with cross-shard
halo exchange and IIR with cross-shard state composition, each against the
dense result, and NorthStarChain sharded end to end (the full-nfft
spectrum kernel on every shard on the card).

    python -m vv_dsp_tpu_torch.examples.multichip_example [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from vv_dsp_tpu_torch import parallel
from vv_dsp_tpu_torch.examples import parse
from vv_dsp_tpu_torch.models import NorthStarChain
from vv_dsp_tpu_torch.ops import fir, iir

SHARDS = 8


def run(device) -> dict:
    mesh = parallel.make_mesh(1, SHARDS, devices=[device] * SHARDS)
    print(f"mesh: {mesh.shape} over {device.type}")

    rng = np.random.default_rng(0)
    n = SHARDS * 6144
    x = torch.as_tensor(rng.standard_normal((4, n)), dtype=torch.float32,
                        device=device)

    # FIR with cross-shard halo exchange == dense result
    h = fir.design_lowpass(255, 0.25, device=device)
    y = parallel.fir_apply_sharded(h, x, mesh).gather()
    fir_err = float(torch.max(torch.abs(y - fir.fir_apply(h, x))))
    print("sharded FIR max |err|:", fir_err)

    # IIR with cross-shard affine state composition
    sos = iir.butter_sos(4, 0.2)
    yi = parallel.iir_apply_sharded(sos, x, mesh).gather()
    iir_err = float(torch.max(torch.abs(yi - iir.iir_apply(sos, x))))
    print("sharded IIR max |err|:", iir_err)

    # Full pipeline, sharded end to end
    chain = NorthStarChain(fir_taps=128, nfft=512, hop=128, n_mels=40,
                           n_mfcc=13, device=device)
    feats = chain.apply_sharded(x, mesh).gather().cpu().numpy()
    print("sharded MFCC features:", feats.shape)
    return {"fir_err": fir_err, "iir_err": iir_err, "fir": y.cpu().numpy(),
            "iir": yi.cpu().numpy(), "feats": feats}


def main(argv=None) -> int:
    _, dev = parse(argv, __doc__)
    if dev is None:
        return 1
    run(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
