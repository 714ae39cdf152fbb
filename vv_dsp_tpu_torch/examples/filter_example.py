"""FIR design + filtering (counterpart of examples/filter_example.py and of
the reference's examples/filter_example.c): design a 33-tap Hamming
windowed-sinc lowpass and filter a square wave, streaming and
whole-signal, then zero-phase and with a Butterworth IIR.

    python -m vv_dsp_tpu_torch.examples.filter_example [--cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from vv_dsp_tpu_torch import streaming
from vv_dsp_tpu_torch.examples import parse
from vv_dsp_tpu_torch.ops import fir, iir


def run(device) -> dict:
    taps, n = 33, 128
    h = fir.design_lowpass(taps, 0.2, "hamming", device=device)
    x = torch.as_tensor(np.where(np.arange(n) % 10 < 5, 1.0, -1.0),
                        dtype=torch.float32, device=device)

    y = fir.fir_apply(h, x)
    print("y[0..4]:", y[:5].cpu().numpy())

    # Same result block-by-block with carried history (the reference's
    # vv_dsp_fir_state contract).
    state = streaming.fir_stream_init(h, device=device)
    outs = []
    for i in range(0, n, 32):
        blk, state = streaming.fir_stream_process(h, state, x[i:i + 32])
        outs.append(blk)
    diff = float(torch.max(torch.abs(y - torch.cat(outs))))
    print("streaming max |diff|:", diff)

    # Zero-phase variant and an IIR Butterworth for comparison.
    yzp = fir.filtfilt_fir(h, x)
    yb = iir.iir_apply(iir.butter_sos(4, 0.2), x)
    rms_zp = float(torch.sqrt(torch.mean(yzp ** 2)))
    rms_b = float(torch.sqrt(torch.mean(yb ** 2)))
    print("filtfilt rms:", rms_zp, "butter rms:", rms_b)
    return {"y": y.cpu().numpy(), "stream_diff": diff,
            "filtfilt": yzp.cpu().numpy(), "butter": yb.cpu().numpy(),
            "filtfilt_rms": rms_zp, "butter_rms": rms_b}


def main(argv=None) -> int:
    _, dev = parse(argv, __doc__)
    if dev is None:
        return 1
    run(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
