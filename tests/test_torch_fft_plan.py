"""The host side of the register-resident FFT (``csrc/fft_reg.cuh``): its
radix plan and per-pass twiddle table, for every N the two spectrum
kernels reach (128 to 2048).

The kernel's passes are replayed in float64 numpy with the kernel's own
index maps (thread j of a frame holds points j + s N/8, s < 8; butterfly
jv = j + u N/8 of a radix-R pass takes register u + r 8/R; its output r
goes to (jv div Ns) Ns R + (jv mod Ns) + r Ns) and the float64 table the
kernel's float32 one is cast from: the result must be ``np.fft.fft`` to
1e-12 of max |X|. The shared-memory swizzle of each exchange is checked to
be a bijection free of bank conflicts for the reads and writes of every
pass, as the kernel makes them.
"""

import numpy as np
import pytest

from vv_dsp_tpu_torch.ops import fft_plan

SIZES = [128, 256, 512, 1024, 2048]
THREADS = 256           # the kernel's block: 2048 / N frames of N / 8 threads


def _dft(v, radix):
    """The radix-point DFT over axis 0, as the kernel's butterflies take it
    (natural order in and out)."""
    k = np.arange(radix)
    return np.exp(-2j * np.pi * np.outer(k, k) / radix) @ v


def _replay(x, n):
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


@pytest.mark.parametrize("n", SIZES)
def test_plan_covers_n(n):
    plan = fft_plan.radix_plan(n)
    assert np.prod(plan) == n
    assert all(r == 8 for r in plan[1:]) and plan[0] in (2, 4, 8)
    assert len(plan) == -(-(n.bit_length() - 1) // 3)
    strides = fft_plan.pass_strides(n)
    assert strides[0] == 1
    assert all(strides[p + 1] == strides[p] * plan[p]
               for p in range(len(plan) - 1))
    offs = fft_plan.pass_offsets(n)
    want = sum((r - 1) * s for r, s in zip(plan[1:], strides[1:]))
    assert offs[-1] == want == len(fft_plan.pass_twiddles_np(n))


@pytest.mark.parametrize("n", SIZES)
def test_replayed_passes_are_the_fft(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got, want = _replay(x, n), np.fft.fft(x)
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("n", SIZES)
def test_kernel_table_is_the_float64_table_cast(n):
    t32 = fft_plan.pass_twiddles_np(n)
    t64 = fft_plan.pass_twiddles_np(n, np.float64)
    assert t32.dtype == np.float32
    np.testing.assert_array_equal(t32, t64.astype(np.float32))
    np.testing.assert_allclose(np.hypot(t64[:, 0], t64[:, 1]), 1.0,
                               rtol=0, atol=1e-15)


def _swizzle(p, ns):
    """fft_reg.cuh's slot of point p in the exchange written by a pass of
    stride ns: XOR the low 4 bits with the bits above (shifted once more
    for ns > 1)."""
    h = p >> 4
    return p ^ (((h << 1) if ns > 1 else h) & 15)


def _wavefronts(addr):
    """Shared-memory wavefronts of one float2 access of a block's threads:
    per half-warp, the most distinct float2 slots on one pair of banks."""
    total = 0
    for h in range(0, len(addr), 16):
        banks = {}
        for a in addr[h:h + 16]:
            banks.setdefault(a % 16, set()).add(a)
        total += max(len(s) for s in banks.values())
    return total


@pytest.mark.parametrize("n", SIZES)
def test_exchanges_are_free_of_bank_conflicts(n):
    t, fb = n // 8, max(1, 2048 // n)
    tid = np.arange(THREADS)
    b, j = tid // t, tid % t
    half_warps = THREADS // 16
    plan, strides = fft_plan.radix_plan(n), fft_plan.pass_strides(n)
    for radix, ns in zip(plan[:-1], strides[:-1]):
        slots = _swizzle(np.arange(n), ns)
        assert sorted(slots) == list(range(n))
        for u in range(8 // radix):
            jv = j + u * t
            for r in range(radix):
                p = (jv // ns) * ns * radix + jv % ns + r * ns
                assert _wavefronts(b * n + _swizzle(p, ns)) == half_warps
        for s in range(8):
            assert _wavefronts(b * n + _swizzle(j + s * t, ns)) == half_warps
    assert fb * t == THREADS


def test_plan_refuses_sizes_off_the_lattice():
    for n in (64, 96, 4096):
        with pytest.raises(ValueError):
            fft_plan.radix_plan(n)
