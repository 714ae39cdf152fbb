"""The passes of ``csrc/fft_reg.cuh``'s register-resident FFT replayed in
float64 numpy with the kernel's own index maps: thread j of a frame holds
points j + s N/8 (s < 8); butterfly jv = j + u N/8 of a radix-R pass takes
register u + r 8/R, multiplies input r by the table's twiddle and writes
output r to (jv div Ns) Ns R + (jv mod Ns) + r Ns."""

import numpy as np

from vv_dsp_tpu_torch.ops import fft_plan


def _dft(v, radix):
    """The radix-point DFT over axis 0, as the kernel's butterflies take it
    (natural order in and out)."""
    k = np.arange(radix)
    return np.exp(-2j * np.pi * np.outer(k, k) / radix) @ v


def replay_fft(x, n):
    """The kernel's passes on one frame x (n points), in float64: the
    registers v[j, s] between passes and the buffer the passes exchange
    through. Returns the last pass's buffer, which must be natural order."""
    t = n // 8
    tw = fft_plan.pass_twiddles_np(n, np.float64)
    tw = tw[:, 0] + 1j * tw[:, 1]
    offs = fft_plan.pass_offsets(n)
    j = np.arange(t)
    v = x[j[:, None] + np.arange(8)[None, :] * t]        # (t, 8)
    for p, (radix, ns) in enumerate(zip(fft_plan.radix_plan(n),
                                        fft_plan.pass_strides(n))):
        buf = np.full(n, np.nan, complex)
        per = 8 // radix
        for u in range(per):
            jv = j + u * t
            regs = u + np.arange(radix) * per
            inp = v[:, regs].T.copy()                    # (radix, t)
            if ns > 1:
                k = jv % ns
                for r in range(1, radix):
                    inp[r] *= tw[offs[p] + (r - 1) * ns + k]
            out = _dft(inp, radix)
            for r in range(radix):
                buf[(jv // ns) * ns * radix + jv % ns + r * ns] = out[r]
        assert not np.isnan(buf).any()
        v = buf[j[:, None] + np.arange(8)[None, :] * t]
    return buf
