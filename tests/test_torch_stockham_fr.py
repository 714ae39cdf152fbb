"""The full-nfft fused gate (``csrc/stockham.cu stockham_gate_kernel``) and
mel/MFCC kernel (``stockham_mel_kernel``) on the register-resident FFT,
replayed in float64 with the kernels' own index maps.

Both transform two real frames at once: thread j of a pair loads points
p = j + s N/8 of z = w (x_f + i x_f+1) / 2 and runs the forward passes of
``csrc/fft_reg.cuh`` (``torch_fft_replay.replay_fft``); from Z[k] and
Z[(N - k) mod N] at its eight k = j + s N/8 it forms X_f[k] = Z[k] + conj
Z[N - k] and X_f+1[k] = (Z[k] - conj Z[N - k]) / i (the window carried the
1/2). The gate takes each frame's peak of re^2 + im^2 (float32, no fused
multiply-add) as a per-thread max reduced by xor shuffles over min(N/8,
32) lanes and then over the frame's warp slots, keeps a bin iff its power
>= float32(t^2 * peak), runs the pair's gated spectra forward again as
conj(H_f + i H_f+1) and reads x_f from the real parts, x_f+1 from the
negated imaginary parts, times 1/N; the overlap-add walks strips of
``fft_plan.owned_segments`` hops, recomputing the frames that reach in from
the left, 4096/N frames a group from each strip's first (``csrc/common.cuh
ola_strip``). The mel kernel walks groups of 4096/N frames of a channel,
writes both frames' powers of bins 0..N/2 from one read of Z[k] and
Z[N - k], and sums each band over the compact filterbank on 4 lanes
(``csrc/mel_dct.cuh``).

Tolerances: the replayed transform against numpy's float64 FFT, 1e-12 of
scale; the gate's kept bins, exactly those of ``gate_plain`` on the same
float32 spectrum; the gate's replay against the float32 plain version,
5e-6 of scale (``chip_smoke.py``'s GATE_TOL) before the norm over the
full length and after it more than nfft from either end, on dense input
at threshold 0 and on bin-centred tones at 0.1 whose bins all lie at most
0.5 or at least 1.5 times the level (checked); the mel replay against the
plain version, 5e-5 of scale for mel energies (the FFT-class contract)
and 5e-6 for MFCCs (MFCC_TOL).
"""

import numpy as np
import pytest
import torch

from torch_fft_replay import replay_fft
from vv_dsp_tpu_torch.ops import fft_plan
from vv_dsp_tpu_torch.ops import istft_kernels as tik
from vv_dsp_tpu_torch.ops import mel as tmel
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops import stockham_kernels as tstk
from vv_dsp_tpu_torch.ops.framing import stft_num_frames
from vv_dsp_tpu_torch.ops.stft import STFT
from vv_dsp_tpu_torch.ops.window import get_window_np

SIZES = [128, 256, 512, 1024, 2048]
BLOCK_BYTES = 232448                     # shared memory a Hopper block holds
MEL_LANES = 4                            # csrc/mel_dct.cuh


def _thread_bins(n):
    """k[j, s] = j + s N/8, the bins thread j of a pair holds, and
    (N - k) mod N."""
    t = n // 8
    k = np.arange(t)[:, None] + np.arange(8)[None, :] * t
    return k, (n - k) & (n - 1)


def _paired_spectrum(a, b, win):
    """Z of the pair's transform input w (a + i b) / 2, in natural order."""
    return replay_fft(0.5 * win * (a + 1j * b), len(win))


def _unpack(z, n):
    """X_f and X_f+1 at each thread's bins, (N/8, 8) each, from Z[k] and
    Z[(N - k) mod N] as the kernel adds them."""
    k, kr = _thread_bins(n)
    p, r = z[k], z[kr]
    return ((p.real + r.real) + 1j * (p.imag - r.imag),
            (p.imag + r.imag) + 1j * (r.real - p.real))


@pytest.mark.parametrize("n", SIZES)
def test_paired_forward_and_unpack_are_each_frames_fft(n):
    """Two real windowed frames through one transform: the unpacked bins,
    placed at each thread's k, are np.fft.fft of each frame, and the
    threads' k cover all N bins once."""
    rng = np.random.default_rng(n)
    a, b = rng.standard_normal((2, n))
    win = get_window_np("hann", n)
    x0, x1 = _unpack(_paired_spectrum(a, b, win), n)
    k, _ = _thread_bins(n)
    assert np.array_equal(np.sort(k.ravel()), np.arange(n))
    for got, frame in ((x0, a), (x1, b)):
        full = np.empty(n, complex)
        full[k] = got
        want = np.fft.fft(win * frame)
        assert np.abs(full - want).max() < 1e-12 * np.abs(want).max()


def _unpack32(z, n):
    """``_unpack`` in float32, as the kernel rounds it."""
    k, kr = _thread_bins(n)
    p, r = z[k], z[kr]
    f = np.float32
    x0 = (p.real + r.real).astype(f) + 1j * (p.imag - r.imag).astype(f)
    x1 = (p.imag + r.imag).astype(f) + 1j * (r.real - p.real).astype(f)
    return x0.astype(np.complex64), x1.astype(np.complex64)


def _thread_mask(x, thresh, n):
    """The kernel's kept-bin mask of one frame at the threads' bins
    (x: (N/8, 8) complex64): power2 in float32, each thread's max over its
    8 bins, xor shuffles over min(N/8, 32) lanes, then the frame's warp
    slots."""
    t = n // 8
    lanes, warps = min(t, 32), max(t // 32, 1)
    p2 = x.real * x.real + x.imag * x.imag
    assert p2.dtype == np.float32
    pk = p2.max(axis=1)
    lane = np.arange(t)
    s = lanes // 2
    while s:
        pk = np.maximum(pk, pk[lane ^ s])
        s //= 2
    peak = pk[::32].max() if warps > 1 else pk[0]
    assert (pk[::lanes] <= peak).all() and peak == p2.max()
    level = np.float32(np.float32(float(thresh) ** 2) * peak)
    return p2 >= level


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("thresh", [0.0, 0.1, 1.0])
def test_thread_gate_keeps_the_plain_bins_and_is_hermitian(n, thresh):
    """On the same float32 spectra, unpacked in float32 from a random
    paired spectrum (a peak off thread 0; a pair of zero frames): each
    frame's unpacked bins are exactly Hermitian, and the threads' mask
    keeps exactly the bins ``gate_plain`` keeps, and is Hermitian too."""
    rng = np.random.default_rng(n + 7)
    zs = (rng.standard_normal((3, n))
          + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    zs[0, 5] *= 40.0
    zs[2] = 0
    k, kr = _thread_bins(n)
    for z in zs:
        for x in _unpack32(z, n):
            full = np.empty(n, np.complex64)
            full[k] = x
            mirror = full[(n - np.arange(n)) % n]
            assert np.array_equal(mirror.real, full.real)
            assert np.array_equal(mirror.imag, -full.imag)
            mask = np.empty(n, bool)
            mask[k] = _thread_mask(x, thresh, n)
            assert np.array_equal(mask, mask[(n - np.arange(n)) % n])
            want = tik.gate_plain(torch.as_tensor(full)[None], thresh)[0]
            np.testing.assert_array_equal(np.where(mask, full, 0),
                                          want.numpy())
            if not z.any():
                assert mask.all()
            elif thresh == 1.0:
                assert mask.sum() in (1, 2)      # the peak and its mirror


def _gate_frames(x, f0, f_hi, nb_pairs, nfft, hop, thresh, win, inside):
    """One group of the kernel: each pair's paired forward, unpack, gate
    (float64 powers), conj(H_f + i H_f+1) forward, times 1/N; frames past
    f_hi load zeros. Returns the group's frames and, per frame wholly
    inside the signal (f < inside), the smallest |p2 / level - 1|."""
    n = len(x)
    k, _ = _thread_bins(nfft)
    frames = np.zeros((2 * nb_pairs, nfft))
    margins = {}

    def frame(g):
        seg = np.zeros(nfft)
        if g <= f_hi:
            part = x[g * hop:g * hop + nfft]
            seg[:len(part)] = part
        return seg

    for p in range(nb_pairs):
        f = f0 + 2 * p
        z = _paired_spectrum(frame(f), frame(f + 1), win)
        hs = []
        for i, xk in enumerate(_unpack(z, nfft)):
            p2 = np.abs(xk) ** 2
            level = thresh ** 2 * p2.max()
            if level > 0 and f + i < inside:
                margins[f + i] = np.abs(p2 / level - 1).min()
            hs.append(np.where(p2 >= level, xk, 0))
        v = np.empty(nfft, complex)
        v[k] = np.conj(hs[0] + 1j * hs[1])
        y = replay_fft(v, nfft)
        frames[2 * p], frames[2 * p + 1] = y.real / nfft, -y.imag / nfft
    return frames, margins


def _gate_replay(x, nfft, hop, thresh, win):
    """The fused gate on one channel in float64, walked as the kernel
    walks it: strip items of gate_segments hops, each from the first frame
    reaching into it, FB = 4096/N frames a group, frames summed into the
    strip in ascending order (ola_strip's order for every sample). Returns
    the output before the norm and the frames' margins to the level."""
    n = len(x)
    nf = stft_num_frames(n, nfft, hop)
    q, seg = nfft // hop, fft_plan.gate_segments(nfft, hop)
    fb = 2 * fft_plan.FR_POINTS // nfft
    strip_len = seg * hop
    inside = (n - nfft) // hop + 1 if n >= nfft else 0
    out = np.zeros(n)
    margins = {}
    for s in range(-(-(-(-n // hop)) // seg)):
        s0 = s * seg
        f_lo, f_hi = max(s0 - (q - 1), 0), min(s0 + seg - 1, nf - 1)
        strip = np.zeros(strip_len)
        for f0 in range(f_lo, f_hi + 1, fb):
            nb = min(fb, f_hi - f0 + 1)
            frames, m = _gate_frames(x, f0, f_hi, fb // 2, nfft, hop,
                                     thresh, win, inside)
            margins.update(m)
            off = (f0 - s0) * hop
            for b in range(nb):          # ascending: each sample's order
                st = off + b * hop
                lo, hi = max(st, 0), min(st + nfft, strip_len)
                if lo < hi:
                    strip[lo:hi] += (frames[b, lo - st:hi - st]
                                     * win[lo - st:hi - st])
        g0 = s0 * hop
        end = min(g0 + strip_len, n)
        out[g0:end] = strip[:end - g0]
    return out, margins


def _tones(n, nfft, channels):
    """Bin-centred tones at 1, 0.3 and 0.05 (bins 10, 25, 45 of 128,
    scaled with nfft): with the periodic Hann window a frame inside the
    signal has 3 nonzero bins a tone, the outer two at 1/4 of the middle
    one's power, so every bin lies at most 0.25 or at least 2.25 times the
    0.1 threshold's level."""
    t = np.arange(n)
    rng = np.random.default_rng(nfft)
    return np.stack([sum(a * np.cos(2 * np.pi * b * (nfft // 128) * t / nfft
                                    + ph)
                         for a, b, ph in zip((1.0, 0.3, 0.05), (10, 25, 45),
                                             rng.uniform(0, 6, 3)))
                     for _ in range(channels)])


@pytest.mark.parametrize("nfft,hop", [(128, 32), (1024, 8)])
@pytest.mark.parametrize("thresh", [0.0, 0.1])
def test_gate_replay_matches_plain(nfft, hop, thresh):
    """Dense input at threshold 0 and the tone probe at 0.1, 9001 samples
    (three strips, so items recompute frames), against
    ``stft_gate_stockham_plain``: before the norm over the full length, and
    after it more than nfft from either end."""
    n = 9001
    if thresh:
        x = _tones(n, nfft, 1)
    else:
        x = np.random.default_rng(hop).standard_normal((1, n))
    x32 = torch.as_tensor(x, dtype=torch.float32)
    win32 = STFT(nfft, hop).win("cpu")
    nf = stft_num_frames(n, nfft, hop)
    norm = tik.ola_norm(get_window_np("hann", nfft), hop, nf, n, "cpu")
    want = tstk.stft_gate_stockham_plain(x32, nfft, hop, win32, norm,
                                         thresh)[0].double().numpy()
    got, margins = _gate_replay(x32[0].double().numpy(), nfft, hop, thresh,
                                win32.double().numpy())
    if thresh:
        assert len(margins) == (n - nfft) // hop + 1
        assert min(margins.values()) > 0.5, min(margins.values())
    norm64 = norm.double().numpy()
    pre = want * norm64
    assert np.abs(got - pre).max() < 5e-6 * np.abs(pre).max()
    err = np.abs(got / norm64 - want)[nfft:-nfft].max()
    assert err < 5e-6 * np.abs(want).max(), err


def _lane_sum(terms):
    """An item's sum as mel_dct takes it: lane l adds terms l, l +
    MEL_LANES, ... in order, then the lanes' xor shuffle tree."""
    part = [sum(terms[lane::MEL_LANES]) for lane in range(MEL_LANES)]
    s = MEL_LANES // 2
    while s:
        part = [part[lane] + part[lane ^ s] for lane in range(MEL_LANES)]
        s //= 2
    return part[0]


def _mel_replay(x, nfft, hop, win, fb, bands, dct, log_eps=1e-10):
    """The mel kernel on one channel in float64: groups of 4096/N frames,
    each pair's paired forward, both frames' powers of bins 0..N/2 from
    Z[k] and Z[N - k] into the group's rows, the lane sums over the compact
    filterbank, then log and the DCT rows; the rows of frames < nf kept."""
    n = len(x)
    nf = stft_num_frames(n, nfft, hop)
    fbk = 2 * fft_plan.FR_POINTS // nfft
    bins = nfft // 2 + 1
    weights, index = fft_plan.compact_filterbank_np(fb, bands)
    weights = weights.astype(np.float64)
    n_mels = fb.shape[0]
    off, lo = index[:n_mels + 1], index[n_mels + 1:]
    kk = np.arange(bins)
    rows = []
    for f0 in range(0, nf, fbk):
        pw = np.zeros((fbk, bins))
        for p in range(fbk // 2):
            frames = []
            for g in (f0 + 2 * p, f0 + 2 * p + 1):
                seg = np.zeros(nfft)
                if g < nf:
                    part = x[g * hop:g * hop + nfft]
                    seg[:len(part)] = part
                frames.append(seg)
            z = _paired_spectrum(*frames, win)
            zk, zr = z[kk], z[(nfft - kk) & (nfft - 1)]
            pw[2 * p] = (zk.real + zr.real) ** 2 + (zk.imag - zr.imag) ** 2
            pw[2 * p + 1] = ((zk.imag + zr.imag) ** 2
                             + (zr.real - zk.real) ** 2)
        for q in range(min(fbk, nf - f0)):
            mel = np.array([_lane_sum(weights[off[b]:off[b + 1]]
                                      * pw[q, lo[b]:lo[b] + off[b + 1]
                                           - off[b]])
                            for b in range(n_mels)])
            if dct is not None:
                lm = np.log(mel + log_eps)
                mel = np.array([_lane_sum(d * lm) for d in dct])
            rows.append(mel)
    return np.array(rows)


@pytest.mark.parametrize("nfft,hop,n_mels,n_mfcc,sr,fuse", [
    (128, 32, 26, 13, 8000.0, True), (1024, 8, 40, 0, 16000.0, False)])
def test_mel_replay_matches_plain(nfft, hop, n_mels, n_mfcc, sr, fuse):
    """MFCCFrontend(128, 32)'s MFCCs (a ragged last group) and 40 mel
    energies at 1024/8 (4 frames a group), against
    ``stft_mel_stockham_plain``."""
    n = 3001
    x = np.random.default_rng(nfft + n_mels).standard_normal(n)
    x32 = torch.as_tensor(x, dtype=torch.float32)[None]
    win, fb, bands, dct = tmel._mfcc_constants(nfft, n_mels, max(n_mfcc, 1),
                                               sr, 0.0, sr / 2, 0.0, "htk",
                                               "hann", None, "cpu")
    nf = stft_num_frames(n, nfft, hop)
    assert nf % (4096 // nfft) or nfft != 128
    want = tstk.stft_mel_stockham_plain(x32, nfft, hop, win, fb,
                                        dct if fuse else None)[0].numpy()
    got = _mel_replay(x32[0].double().numpy(), nfft, hop,
                      win.double().numpy(), fb.numpy(), bands.numpy(),
                      dct.double().numpy() if fuse else None)
    assert got.shape == want.shape
    tol = 5e-6 if fuse else 5e-5
    assert np.abs(got - want).max() < tol * np.abs(want).max()


def _mel_geometries():
    for nfft in SIZES:
        for hop in range(8, nfft + 1, 8):
            if tstk.stockham_supported(nfft, hop):
                yield nfft, hop


def test_gate_blocks_fit_at_every_geometry_the_wrapper_takes():
    """At every geometry stockham_gate_supported takes: the strip is
    owned_segments rounded up to the fewest segments whose item frames
    fill whole groups, stockham_gate_smem the inverse's layout with that
    strip and a pair of peak slots a warp, and two blocks fit an SM (228
    KB, 1 KB reserved a block); largest at 2048/16, three blocks at
    128/32."""
    sizes = {}
    for nfft, hop in _mel_geometries():
        if not tstk.stockham_gate_supported(nfft, hop):
            assert hop == nfft
            continue
        q1, fb = nfft // hop - 1, 4096 // nfft
        seg = fft_plan.gate_segments(nfft, hop)
        owned = fft_plan.owned_segments(nfft, hop)
        assert owned <= seg < owned + fb and (seg + q1) % fb == 0
        smem = fft_plan.stockham_gate_smem(nfft, hop)
        assert smem == 8 * (fft_plan.table_size(nfft) + 4096 + 8) + 4 * (
            nfft + seg * hop)
        assert 2 * (smem + 1024) <= 233472, (nfft, hop)
        sizes[nfft, hop] = smem
    assert max(sizes, key=sizes.get) == (2048, 16)
    assert sizes[2048, 16] == 89952
    assert fft_plan.gate_segments(128, 32) == 157
    assert 3 * (sizes[128, 32] + 1024) <= 233472


@pytest.mark.parametrize("n_mels,n_mfcc", [(26, 13), (128, 40)])
def test_mel_plans_fit_at_every_geometry_the_wrapper_takes(n_mels, n_mfcc):
    """stockham_mel_plan at every geometry stockham_supported takes, with
    the filterbank's own weight count: staged and within the staging budget
    (mfcc_plan's layout less wk, with the nfft-point table), for both the
    MFCCs and the mel energies; at most nfft/2 bands."""
    for nfft, hop in _mel_geometries():
        bands_n = min(n_mels, nfft // 2)
        fb = tmel.mel_filterbank_np(nfft, bands_n, 16000.0, 0.0, 8000.0,
                                    "htk").astype(np.float32)
        nnz = fft_plan.compact_filterbank_np(fb, tsk.band_edges_np(fb))[0]
        for fuse in (True, False):
            plan = fft_plan.stockham_mel_plan(nfft, bands_n, n_mfcc,
                                              nnz.size, fuse)
            rows = 4096 // nfft * bands_n if fuse else 0
            tables = nnz.size + (n_mfcc * bands_n if fuse else 0)
            assert plan.staged, (nfft, hop)
            assert plan.smem == 8 * (fft_plan.table_size(nfft) + 4096) + 4 * (
                rows + 2 * bands_n + 1 + tables)
            assert plan.smem <= fft_plan.MFCC_SMEM_BUDGET
