"""The host side of the register-resident FFT (``csrc/fft_reg.cuh``): its
radix plan and per-pass twiddle table, for every N its kernels reach (128 to
2048), and the packed MFCC kernel's plan: its compact filterbank, replayed
with the kernel's lane sums against the dense products, and its
shared-memory layout at the ends of its lattice.

The kernel's passes are replayed in float64 numpy with the kernel's own
index maps (``torch_fft_replay``) and the float64 table the kernel's
float32 one is cast from: the result must be ``np.fft.fft`` to
1e-12 of max |X|. The shared-memory swizzle of each exchange is checked to
be a bijection free of bank conflicts for the reads and writes of every
pass, as the kernel makes them.
"""

import numpy as np
import pytest

from torch_fft_replay import replay_fft
from vv_dsp_tpu_torch.ops import fft_plan

SIZES = [128, 256, 512, 1024, 2048]
THREADS = 256           # the kernel's block: 2048 / N frames of N / 8 threads


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
    got, want = replay_fft(x, n), np.fft.fft(x)
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


# ---- the packed MFCC kernel's host plan (csrc/stft.cu stft_mfcc_kernel) ---

MEL_LANES = 4   # threads summing one band or coefficient (csrc/stft.cu)


def _lane_sum(terms):
    """One frame's sum of an item as the kernel takes it: lane l adds terms
    l, l + MEL_LANES, ... in order, then the lanes' xor shuffle tree."""
    part = [sum(terms[lane::MEL_LANES]) for lane in range(MEL_LANES)]
    s = MEL_LANES // 2
    while s:
        part = [part[lane] + part[lane ^ s] for lane in range(MEL_LANES)]
        s //= 2
    return part[0]


def _mel_replay(power, weights, index, n_mels):
    """The kernel's mel sums over the compact filterbank, in float64."""
    off, lo = index[:n_mels + 1], index[n_mels + 1:]
    return np.array([[_lane_sum(weights[off[b]:off[b + 1]]
                                * row[lo[b]:lo[b] + off[b + 1] - off[b]])
                      for b in range(n_mels)] for row in power])


def _filterbank(name):
    """(mel_fb float32 numpy, band edges, dct rows) of a geometry the MFCC
    kernel runs."""
    from vv_dsp_tpu_torch.models import MFCCFrontend, NorthStarChain
    from vv_dsp_tpu_torch.ops import mel as tmel
    from vv_dsp_tpu_torch.ops import stft_kernels as tsk
    if name in ("chain", "frontend"):
        mod = (NorthStarChain if name == "chain" else MFCCFrontend)(
            device="cpu")
        return (mod.mel_fb.numpy(), mod.mel_bands.numpy(),
                mod.dct_lift.numpy().astype(np.float64))
    fb = tmel.mel_filterbank_np(4096, 64, 48000.0, 0.0, 24000.0, "htk")
    if name == "zero band":
        fb = fb.copy()
        fb[5] = 0.0
    fb = fb.astype(np.float32)
    return fb, tsk.band_edges_np(fb), tmel.mfcc_dct_np(64, 30)


@pytest.mark.parametrize("name", ["chain", "frontend", "4096 64 mels",
                                  "zero band"])
def test_compact_filterbank_contraction_is_the_dense_product(name):
    """The chain's, MFCCFrontend()'s and a 4096-point 64-mel filterbank,
    and one with an all-zero band (an empty range): the compact form holds
    exactly the nonzero weights, and the kernel's lane sums over it, then
    over the DCT rows, are the dense products to 1e-12."""
    fb, bands, dct = _filterbank(name)
    weights, index = fft_plan.compact_filterbank_np(fb, bands)
    n_mels = fb.shape[0]
    assert weights.dtype == np.float32 and index.dtype == np.int32
    assert index.shape == (2 * n_mels + 1,) and index[0] == 0
    assert weights.size == index[n_mels] == np.count_nonzero(fb)
    if name == "zero band":
        assert index[5] == index[6]
    power = np.random.default_rng(n_mels).uniform(0, 2, (3, fb.shape[1]))
    got = _mel_replay(power, weights.astype(np.float64), index, n_mels)
    want = power @ fb.astype(np.float64).T
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()
    log_mel = np.log(want + 1e-10)
    got = np.array([[_lane_sum(d * row) for d in dct] for row in log_mel])
    want = log_mel @ dct.T
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("nfft,n_mels,n_mfcc,nnz,fuse,staged", [
    (256, 24, 12, 236, True, True),        # the lattice's small end
    (2048, 80, 20, 1997, True, True),      # the chain
    (1024, 26, 13, 970, True, True),       # MFCCFrontend()
    (4096, 64, 30, 3979, True, True),      # the large end
    (4096, 128, 128, 4095, True, False),   # the DCT outgrows the budget
    (4096, 128, 128, 4095, False, True),   # mel energies: no DCT
    (256, 2500, 13, 258, True, False)])    # 16 frames of 2500 log-mels
def test_mfcc_plan_layout(nfft, n_mels, n_mfcc, nnz, fuse, staged):
    plan = fft_plan.mfcc_plan(nfft, n_mels, n_mfcc, nnz, fuse)
    m = nfft // 2
    rows = 2048 // m * n_mels if fuse else 0
    tables = nnz + (n_mfcc * n_mels if fuse else 0)
    fixed = 8 * (len(fft_plan.pass_twiddles_np(m)) + m + 1 + 4096)
    assert plan.staged == staged
    assert plan.smem == fixed + 4 * (rows + 2 * n_mels + 1
                                     + (tables if staged else 0))
    assert plan.smem <= (fft_plan.MFCC_SMEM_BUDGET if staged
                         else fft_plan.SMEM_BYTES)
    assert 2 * (fft_plan.MFCC_SMEM_BUDGET + 1024) <= 233472
    if (nfft, n_mels) == (2048, 80):        # three chain blocks an SM
        assert 3 * (plan.smem + 1024) <= 233472


def test_mfcc_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError):
        fft_plan.mfcc_plan(256, 4000, 13, 258, True)
