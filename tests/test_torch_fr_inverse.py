"""The full-nfft inverse on the register-resident FFT
(``csrc/stockham.cu istft_stockham_kernel``), replayed in float64 with the
kernel's own index maps.

A transform inverts two real frames: thread j of a pair loads points
k = j + s N/8 of conj(Z), Z = H_f + i H_f+1, H a frame's Hermitian part
(with all bins 2 H[k] = X[k] + conj X[(N - k) mod N]; one-sided, X[k] up to
N/2 and conj X[N - k] above, the DC and Nyquist bins real), runs the forward
passes of ``csrc/fft_reg.cuh`` (``torch_fft_replay.replay_fft``) and reads
x_f from the real parts, x_f+1 from the negated imaginary parts, times
(1 or 1/2) / N. The overlap-add walk is the kernel's: a block owns
``fft_plan.owned_segments`` hop-long segments, recomputes the frames
reaching in from the left, takes 2 * 2048 / N frames at a time and sums,
for each sample, only the frames covering it (``csrc/common.cuh
ola_strip``), in ascending order.
"""

import numpy as np
import pytest

from torch_fft_replay import replay_fft
from vv_dsp_tpu_torch.ops import fft_plan
from vv_dsp_tpu_torch.ops.stockham_kernels import stockham_supported

SIZES = [128, 256, 512, 1024, 2048]


def _paired_input(spec, f, last, n, rfft):
    """conj(H_f + i H_f+1) in natural order, as the pair's threads load it
    (a frame past `last` is zero; with all bins, 2 H)."""
    t = n // 8
    k = np.arange(t)[:, None] + np.arange(8)[None, :] * t     # [j, s]
    kr = (n - k) & (n - 1)

    def hermitian(g):
        if g > last:
            return np.zeros(k.shape, complex)
        x = spec[g]
        if rfft:
            v = x[np.where(k <= n // 2, k, kr)]
            im = np.where(k <= n // 2, v.imag, -v.imag)
            return v.real + 1j * np.where((k == 0) | (k == n // 2), 0.0, im)
        p, r = x[k], x[kr]
        return (p.real + r.real) + 1j * (p.imag - r.imag)

    h0, h1 = hermitian(f), hermitian(f + 1)
    z = np.empty(n, complex)
    z[k] = (h0.real - h1.imag) - 1j * (h0.imag + h1.real)
    return z


def _kernel_frames(spec, n, rfft, last=None):
    """Every frame's inverse as the kernel forms it, pair by pair from 0."""
    nf = spec.shape[0]
    last = nf - 1 if last is None else last
    scale = (1.0 if rfft else 0.5) / n
    frames = np.zeros((nf + 1, n))
    for f in range(0, nf, 2):
        y = replay_fft(_paired_input(spec, f, last, n, rfft), n)
        frames[f], frames[f + 1] = y.real * scale, -y.imag * scale
    return frames[:nf]


def _spectrum(rng, nf, bins):
    return rng.standard_normal((nf, bins)) + 1j * rng.standard_normal(
        (nf, bins))


@pytest.mark.parametrize("n", SIZES)
def test_paired_inverse_is_irfft(n):
    """One-sided input, the DC and Nyquist imaginary parts set (irfft drops
    them), an odd frame count (the last frame's partner is zero)."""
    spec = _spectrum(np.random.default_rng(n), 5, n // 2 + 1)
    got, want = _kernel_frames(spec, n, True), np.fft.irfft(spec, n)
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("n", SIZES)
def test_paired_inverse_keeps_the_real_part_of_all_bins(n):
    """All n bins of a non-Hermitian spectrum: the real part of each
    frame's complex inverse, an odd frame count."""
    spec = _spectrum(np.random.default_rng(n + 1), 5, n)
    got, want = _kernel_frames(spec, n, False), np.fft.ifft(spec).real
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def test_paired_inverse_zeroes_frames_past_the_last():
    """A pair straddling the block's last frame keeps its first frame."""
    spec = _spectrum(np.random.default_rng(3), 4, 65)
    got = _kernel_frames(spec, 128, True, last=2)
    want = np.fft.irfft(spec, 128)
    assert np.abs(got[:3] - want[:3]).max() < 1e-12 * np.abs(want).max()
    y = replay_fft(_paired_input(spec, 2, 2, 128, True), 128)
    assert np.abs(y.imag).max() < 1e-12 * np.abs(want).max()


def _strip_walk(nfft, hop, nf, out_len):
    """The kernel's overlap-add walk: for every output sample, the frames
    summed into it in order, and each sample's owning block."""
    q, seg = nfft // hop, fft_plan.owned_segments(nfft, hop)
    fb = 2 * fft_plan.FR_POINTS // nfft
    strips = -(-(-(-out_len // hop)) // seg)
    summed = [[] for _ in range(out_len)]
    owner = np.full(out_len, -1)
    firsts = set()
    for s in range(strips):
        s0, strip_len = s * seg, seg * hop
        f_lo, f_hi = max(s0 - (q - 1), 0), min(s0 + seg - 1, nf - 1)
        strip = [[] for _ in range(strip_len)]
        f0 = f_lo
        while f0 <= f_hi:
            firsts.add(f0 % 2)
            nb, off = min(fb, f_hi - f0 + 1), (f0 - s0) * hop
            for t in range(max(off, 0),
                           min(off + (nb - 1) * hop + nfft, strip_len)):
                d = t - off
                first = max((d - nfft) // hop + 1, 0)
                for b in range(first, min(d // hop, nb - 1) + 1):
                    assert 0 <= d - b * hop < nfft
                    strip[t].append(f0 + b)
            f0 += fb
        for t in range(strip_len):
            g = s0 * hop + t
            if g < out_len:
                assert owner[g] == -1
                owner[g] = s
                summed[g] = strip[t]
    return summed, owner, firsts


@pytest.mark.parametrize("nfft,hop,nf,parities", [
    (128, 32, 300, {0, 1}), (128, 8, 1100, {0, 1}), (1024, 256, 40, {0, 1}),
    (2048, 16, 450, {0, 1}), (256, 256, 40, {0}), (512, 128, 1, {0})])
def test_strip_walk_sums_every_covering_frame_once_in_order(nfft, hop, nf,
                                                            parities):
    """Every sample owned by one block, which sums exactly the frames
    covering it, in ascending order; groups start at even and odd frames
    where a block recomputes frames (q > 1)."""
    cover = (nf - 1) * hop + nfft
    for out_len in (cover, max(cover - hop - 5, nfft // 2), cover + 2 * nfft):
        summed, owner, firsts = _strip_walk(nfft, hop, nf, out_len)
        assert (owner >= 0).all()
        for g in range(out_len):
            lo = max(0, -(-(g - nfft + 1) // hop))
            assert summed[g] == list(range(lo, min(g // hop, nf - 1) + 1)), g
        assert firsts == parities


@pytest.mark.parametrize("nfft,hop", [(128, 32), (1024, 256), (2048, 512)])
@pytest.mark.parametrize("rfft", [False, True])
def test_kernel_replay_is_the_inverse_stft(nfft, hop, rfft):
    """The strip walk over the paired frames, each block's groups starting
    where its frames do, against irfft / ifft, windowed and overlap-added
    in float64 (before the norm, which both divide by alike)."""
    nf = 9
    rng = np.random.default_rng(nfft + hop)
    spec = _spectrum(rng, nf, nfft // 2 + 1 if rfft else nfft)
    win = rng.uniform(0.5, 1.0, nfft)
    out_len = (nf - 1) * hop + nfft
    frames = np.fft.irfft(spec, nfft) if rfft else np.fft.ifft(spec).real
    want = np.zeros(out_len)
    for f in range(nf):
        want[f * hop:f * hop + nfft] += frames[f] * win
    summed, _, _ = _strip_walk(nfft, hop, nf, out_len)
    q, seg = nfft // hop, fft_plan.owned_segments(nfft, hop)
    fb = 2 * fft_plan.FR_POINTS // nfft
    got = np.zeros(out_len)
    for s in range(-(-(-(-out_len // hop)) // seg)):
        f_lo, f_hi = max(s * seg - (q - 1), 0), min(s * seg + seg - 1, nf - 1)
        kernel = {}
        for f0 in range(f_lo, f_hi + 1, fb):
            part = _kernel_frames(spec[f0:f0 + fb], nfft, rfft,
                                  last=f_hi - f0)
            kernel.update({f0 + b: part[b] for b in range(len(part))})
        for g in range(s * seg * hop, min((s + 1) * seg * hop, out_len)):
            got[g] = sum(kernel[f][g - f * hop] * win[g - f * hop]
                         for f in summed[g])
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def test_inverse_blocks_fit_shared_memory():
    """Every geometry stockham_supported takes: two blocks fit an SM (228
    KB, 1 KB reserved a block)."""
    for n in SIZES:
        for hop in (h for h in range(8, n + 1, 8) if stockham_supported(n, h)):
            smem = fft_plan.istft_smem(n, hop)
            assert 2 * (smem + 1024) <= 233472, (n, hop)
            assert smem == 8 * (fft_plan.table_size(n) + 4096) + 4 * (
                n + fft_plan.owned_segments(n, hop) * hop)
