"""The packed inverse (``csrc/istft.cu istft_kernel``) and the packed fused
gate (``csrc/gate_packed.cu stft_gate_packed_kernel``) on the
register-resident FFT, replayed in float64 with the kernels' own index maps.

Thread j of a frame (M = nfft/2 points, M/8 threads) holds bins k and
M - k for its eight k = j + s M/8. The inverse repacks them (``packed.cuh
repack_bin``: the DC and Nyquist imaginary parts dropped, scale 1/nfft),
conjugates, runs the forward passes of ``csrc/fft_reg.cuh``
(``torch_fft_replay.replay_fft``) and reads sample 2n from the real part
and sample 2n + 1 from the negated imaginary part of point n. With the
gate, each thread first takes the max of re^2 + im^2 (float32, no fused
multiply-add) over its 16 bins, the frame's threads reduce it by xor
shuffles within a warp, then through one slot a warp where a frame spans
warps, and a bin is kept iff its power >= float32(t^2 * peak). The fused
gate runs the packed forward (``packed_frame_regs``: point p = (w x)[2p] +
i (w x)[2p+1]), unpacks X[k] and X[M - k] from Z[k] and Z[(M - k) mod M]
(``unpack_pair``), then gates and inverts as above. The overlap-add walk
(``csrc/common.cuh ola_strip``, 2048/M frames a group) is the full-nfft
inverse's, replayed in ``tests/test_torch_fr_inverse.py``.

Tolerances: the replays against numpy's float64 FFT, 1e-12 of scale; the
gate's kept bins, exactly those of ``gate_plain`` on the same float32
spectrum; the fused gate's replay against the float32 plain version on the
samples every covering frame of which lies in the signal, 5e-6 of scale
(``chip_smoke.py``'s GATE_TOL), on dense input at threshold 0 and on a
probe of bin-centred tones whose bins all lie at most 0.5 or at least 1.5
times the 0.1 threshold's level (checked), so no bin can flip between the
two precisions.
"""

import numpy as np
import pytest
import torch

from torch_fft_replay import replay_fft
from vv_dsp_tpu_torch.ops import fft_plan
from vv_dsp_tpu_torch.ops import istft_kernels as tik
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops.framing import stft_num_frames
from vv_dsp_tpu_torch.ops.stft import STFT
from vv_dsp_tpu_torch.ops.window import get_window_np

SIZES = [128, 256, 512, 1024, 2048]      # M, the packed transform's points
BLOCK_BYTES = 232448                     # shared memory a Hopper block holds


def _thread_bins(m):
    """k[j, s] = j + s M/8, the bins thread j loads, and M - k."""
    t = m // 8
    k = np.arange(t)[:, None] + np.arange(8)[None, :] * t
    return k, m - k


def _wk(m):
    return np.exp(-2j * np.pi * np.arange(m + 1) / (2 * m))


def _repack(a, r, k, m):
    """``repack_bin`` in float64: Z[k] / nfft from a = X[k], r = X[M - k];
    at k = 0 the imaginary parts of X[0] and X[M] dropped."""
    a = np.where(k == 0, a.real, a)
    r = np.where(k == 0, r.real, r)
    e, d = a + np.conj(r), a - np.conj(r)
    return (e + 1j * np.conj(_wk(m)[k]) * d) / (2 * m)


def _inverse(x, r, m):
    """One frame's inverse from the bins thread j holds (x[j, s] = X[k],
    r[j, s] = X[M - k]): repack, conjugate, the forward passes, conjugate;
    the frame's 2M samples."""
    k, _ = _thread_bins(m)
    z = np.empty(m, complex)
    z[k] = np.conj(_repack(x, r, k, m))
    u = replay_fft(z, m)
    y = np.empty(2 * m)
    y[0::2], y[1::2] = u.real, -u.imag
    return y


def _inverse_frames(spec, m, last):
    """Each frame's inverse as the kernel loads it: frames past `last` (the
    block's last) load zeros."""
    k, kr = _thread_bins(m)
    out = []
    for f, x in enumerate(spec):
        if f > last:
            x = np.zeros_like(x)
        out.append(_inverse(x[k], x[kr], m))
    return np.array(out)


@pytest.mark.parametrize("m", SIZES)
def test_register_load_inverse_is_irfft(m):
    """Every M: a random one-sided spectrum with nonzero DC and Nyquist
    imaginary parts (irfft drops them), and a frame past the block's last,
    which inverts to zeros."""
    rng = np.random.default_rng(m)
    spec = rng.standard_normal((3, m + 1)) + 1j * rng.standard_normal(
        (3, m + 1))
    assert (np.abs(spec[:, [0, m]].imag) > 1e-3).all()
    got = _inverse_frames(spec, m, last=1)
    want = np.fft.irfft(spec, 2 * m)
    assert np.abs(got[:2] - want[:2]).max() < 1e-12 * np.abs(want).max()
    assert (got[2] == 0).all()


def _thread_gate(spec32, thresh, m):
    """The kernel's kept-bin mask of each frame (rows of spec32, complex64):
    power2 in float32, each thread's max over its 16 bins, xor shuffles
    over min(M/8, 32) lanes, then over the frame's warp slots."""
    t = m // 8
    lanes, warps = min(t, 32), max(t // 32, 1)
    k, kr = _thread_bins(m)
    p2 = (spec32.real * spec32.real + spec32.imag * spec32.imag)
    assert p2.dtype == np.float32
    masks = []
    for row in p2:
        pk = np.maximum(row[k], row[kr]).max(axis=1)          # (t,)
        lane = np.arange(t)
        s = lanes // 2
        while s:
            pk = np.maximum(pk, pk[lane ^ s])
            s //= 2
        # each warp's lanes now hold its max; a frame spanning warps takes
        # the max of its warps' slots
        peak = pk[::32].max() if warps > 1 else pk[0]
        assert peak == row.max()
        level = np.float32(np.float32(float(thresh) ** 2) * peak)
        masks.append(row >= level)
    return np.array(masks)


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("thresh", [0.0, 0.1, 1.0])
def test_thread_gate_keeps_the_plain_bins(m, thresh):
    """On the same float32 spectrum (a frame of zeros among them) the
    lane-then-warp peak keeps exactly the bins ``gate_plain`` keeps."""
    rng = np.random.default_rng(m + 7)
    spec = (rng.standard_normal((5, m + 1))
            + 1j * rng.standard_normal((5, m + 1))).astype(np.complex64)
    spec[:, 3] *= 40.0                          # a peak off thread 0
    spec[2] = 0
    mask = _thread_gate(spec, thresh, m)
    sp = torch.as_tensor(spec)
    want = tik.gate_plain(sp, thresh).numpy()
    np.testing.assert_array_equal(np.where(mask, spec, 0), want)
    assert mask[2].all()
    if thresh == 1.0:
        assert mask.sum(axis=1).tolist() == [1, 1, m + 1, 1, 1]


def _fused_gate_replay(x, nfft, hop, thresh, win, norm):
    """The fused gate on one channel, in float64: each frame's packed
    forward and unpack from the result, the gate on float64 powers, the
    inverse, the window and the overlap-add, divided by the norm. Returns
    the output and each frame's smallest |p2 / level - 1| over its bins."""
    m, n = nfft // 2, len(x)
    nf = stft_num_frames(n, nfft, hop)
    k, kr = _thread_bins(m)
    wk = _wk(m)
    out = np.zeros(n + nfft)
    margin = np.full(nf, np.inf)
    for f in range(nf):
        seg = np.zeros(nfft)
        part = x[f * hop:f * hop + nfft]
        seg[:len(part)] = part
        seg *= win
        z = replay_fft(seg[0::2] + 1j * seg[1::2], m)
        p, q = z[k], z[(m - k) & (m - 1)]
        xk = _unpack(p, q, wk[k])
        xr = _unpack(q, p, wk[kr])
        p2k, p2r = np.abs(xk) ** 2, np.abs(xr) ** 2
        level = thresh ** 2 * max(p2k.max(), p2r.max())
        if level > 0:
            margin[f] = np.abs(np.concatenate([p2k, p2r]) / level - 1).min()
        xk, xr = np.where(p2k >= level, xk, 0), np.where(p2r >= level, xr, 0)
        out[f * hop:f * hop + nfft] += _inverse(xk, xr, m) * win
    return out[:n] / norm, margin


def _unpack(a, b, w):
    """``unpack_pair`` in float64: X[k] from a = Z[k], b = Z[(M - k) mod M]
    and w = wk[k]."""
    e = (a + np.conj(b)) / 2
    o = (a - np.conj(b)) / 2j
    return e + w * o


def _tones(n, nfft, channels):
    """Bin-centred tones at 1, 0.3 and 0.05 (bins 10, 40 and 90 of nfft):
    with the periodic Hann window a frame inside the signal has 3 nonzero
    bins a tone, at 1, 1/4 of the tone's peak power."""
    t = np.arange(n)
    rng = np.random.default_rng(nfft)
    return np.stack([sum(a * np.cos(2 * np.pi * b * t / nfft + ph)
                         for a, b, ph in zip((1.0, 0.3, 0.05), (10, 40, 90),
                                             rng.uniform(0, 6, 3)))
                     for _ in range(channels)])


@pytest.mark.parametrize("nfft,hop", [(512, 128), (1024, 256)])
@pytest.mark.parametrize("thresh", [0.0, 0.1])
def test_fused_gate_replay_matches_plain(nfft, hop, thresh):
    """Dense input at threshold 0, the tone probe at 0.1 (every bin of
    every frame inside the signal at most 0.5 or at least 1.5 times the
    level), on the samples whose covering frames all lie in the signal."""
    n = 6 * nfft + 37
    if thresh:
        x = _tones(n, nfft, 2)
    else:
        x = np.random.default_rng(hop).standard_normal((2, n))
    x32 = torch.as_tensor(x, dtype=torch.float32)
    win32 = STFT(nfft, hop).win("cpu")
    norm = tik.periodic_norm(get_window_np("hann", nfft), hop, n, "cpu")
    want = tik.stft_gate_packed_plain(x32, nfft, hop, thresh, win32,
                                      norm).double().numpy()
    edge = nfft
    inside = (n - nfft) // hop + 1      # frames wholly inside the signal
    for c in range(2):
        got, margin = _fused_gate_replay(
            x32[c].double().numpy(), nfft, hop, thresh,
            win32.double().numpy(), norm.double().numpy())
        if thresh:
            assert margin[:inside].min() > 0.5, margin[:inside].min()
        err = np.abs(got - want[c])[edge:-edge].max()
        assert err < 5e-6 * np.abs(want[c]).max(), err


def _reckoned_gate(nfft, hop):
    """The packed overlap-add block, laid out by hand: the M-point twiddle
    table, wk, two 2048-point exchanges, the window, 8 peak slots and the
    strip (owned_segments hops)."""
    m, q = nfft // 2, nfft // hop
    seg = max(4 * (q - 1), -(-4096 // hop), 1)
    return 8 * (len(fft_plan.pass_twiddles_np(m)) + (m + 1) + 2 * 2048) \
        + 4 * (nfft + 8 + seg * hop)


def _reckoned(nfft, hop):
    """The inverse's block: the spectrum stage (a group's 2048/M rows of
    M + 1 bins plus one float2 at each end, rounded down to 16 bytes), then
    the packed overlap-add block without the twiddle table."""
    m = nfft // 2
    stage = 8 * (2048 // m * (m + 1) + 2) // 16 * 16
    return stage + _reckoned_gate(nfft, hop) \
        - 8 * len(fft_plan.pass_twiddles_np(m))


@pytest.mark.parametrize("nfft", [256, 4096])
@pytest.mark.parametrize("hop_of", [lambda n: n, lambda n: n // 4,
                                    lambda n: 1])
def test_inverse_plan_fits_a_block(nfft, hop_of):
    hop = hop_of(nfft)
    assert tik.istft_supported(nfft, hop)
    smem = fft_plan.packed_istft_smem(nfft, hop)
    assert smem == _reckoned(nfft, hop)
    assert smem <= BLOCK_BYTES, (nfft, hop, smem)


@pytest.mark.parametrize("nfft,hop", [(256, 128), (256, 16), (4096, 2048),
                                      (4096, 32)])
def test_gate_plan_fits_a_block(nfft, hop):
    """The ends of packed_gate_supported's lattice: hop = nfft/2 and its
    smallest hop (a multiple of 16 with nfft/hop <= 128)."""
    hops = [h for h in range(1, nfft + 1)
            if tsk.packed_gate_supported(nfft, h)]
    assert hop in (min(hops), max(hops))
    smem = fft_plan.gate_packed_smem(nfft, hop)
    assert smem == _reckoned_gate(nfft, hop)
    assert smem <= BLOCK_BYTES, (nfft, hop, smem)


def test_plans_at_every_geometry_the_wrappers_take():
    """Every (nfft, hop) of both lattices fits a block, and the largest,
    nfft 4096 at hop 1, is the one the plan's docstring gives."""
    for nfft in (256, 512, 1024, 2048, 4096):
        for hop in (h for h in range(1, nfft + 1) if nfft % h == 0):
            assert tik.istft_supported(nfft, hop)
            assert fft_plan.packed_istft_smem(nfft, hop) <= BLOCK_BYTES
    assert fft_plan.packed_istft_smem(4096, 1) == 147496
    assert fft_plan.packed_istft_smem(1024, 256) == 73816


def test_gate_plan_keeps_its_own_layout():
    """The fused gate reads no spectrum, so its block has no stage: at every
    geometry of packed_gate_supported its plan is the overlap-add block
    alone (61,416 bytes at 1024/256), and the inverse's is that block with
    the stage in place of the twiddle table."""
    n = 0
    for nfft in (256, 512, 1024, 2048, 4096):
        for hop in range(1, nfft + 1):
            if not tsk.packed_gate_supported(nfft, hop):
                continue
            gate = fft_plan.gate_packed_smem(nfft, hop)
            assert gate == _reckoned_gate(nfft, hop), (nfft, hop)
            assert fft_plan.packed_istft_smem(nfft, hop) == (
                gate + fft_plan.istft_stage_bytes(nfft)
                - 8 * fft_plan.table_size(nfft // 2))
            n += 1
    assert n > 20
    assert fft_plan.gate_packed_smem(1024, 256) == 61416


def _walk(channels, nf, nfft, hop, output_len, blocks):
    """Each block's frame groups in the order its threads compute them
    (``csrc/istft.cu istft_kernel``'s loops over StripItems), and in the
    order thread 0 copies them (``CopyCursor``: item (c, s) of channel c
    and strip s, entered at its first frame, a step of 2048/m frames after
    each copy, then past finished items), each as (channel, first frame,
    frames)."""
    m = nfft // 2
    seg, q, fb = fft_plan.owned_segments(nfft, hop), nfft // hop, 2048 // m
    per_row = -(-(-(-output_len // hop)) // seg)
    strips = per_row * channels

    def frames(s):
        s0 = s * seg
        return max(s0 - (q - 1), 0), min(s0 + seg - 1, nf - 1)

    walks, copies = [], []
    for b in range(blocks):
        walk = []
        for g in range(b, strips, blocks):
            c, (f_lo, f_hi) = g // per_row, frames(g % per_row)
            walk += [(c, f0, min(fb, f_hi - f0 + 1))
                     for f0 in range(f_lo, f_hi + 1, fb)]
        walks.append(walk)
        copy = []
        if b < strips:
            c, s = b // per_row, b % per_row
            f, f_hi = frames(s)
            while True:
                while f > f_hi:                  # seek
                    s += blocks
                    if s >= per_row:
                        c, s = c + s // per_row, s % per_row
                    if c * per_row + s >= strips:
                        break
                    f, f_hi = frames(s)
                if c * per_row + s >= strips:    # done
                    break
                copy.append((c, f, min(fb, f_hi - f + 1)))
                f += fb
        copies.append(copy)
    return walks, copies


@pytest.mark.parametrize("nfft,hop,channels,nf,out_len,blocks", [
    (1024, 256, 5, 75, 19456, 7),      # items across channels, a block's
    (4096, 512, 5, 32, 20480, 3),      # walk carried from row to row
    (1024, 256, 2, 3, 1536, 4),        # nf < 2048/M
    (1024, 256, 3, 2, 6000, 4),        # items with no frames
    (256, 64, 3, 40, 2900, 2),         # output past the frames' cover
    (4096, 1, 1, 9000, 9000, 5),       # hop 1, one frame a group
])
def test_ring_walk_copies_each_group_once_in_order(nfft, hop, channels, nf,
                                                   out_len, blocks):
    """Thread 0's copy cursor visits exactly the groups its block computes,
    in the same order, across strip items and channels; their total is
    fft_plan.istft_groups (what ring_tally counts). Each copy, its start
    rounded down to 16 bytes and its end up, fits a stage; a stage read at
    the kernel's offset (0 or 1 float2) and bins k and M - k gives every
    frame's bins, for a row base of either 16-byte phase."""
    m = nfft // 2
    bins = m + 1
    walks, copies = _walk(channels, nf, nfft, hop, out_len, blocks)
    assert walks == copies
    assert sum(map(len, walks)) == fft_plan.istft_groups(
        channels, nf, nfft, hop, out_len)
    stage = fft_plan.istft_stage_bytes(nfft) // 8
    rng = np.random.default_rng(nfft + hop)
    spec = rng.standard_normal(channels * nf * bins + 4)
    k = np.arange(m // 8)[:, None] + np.arange(8)[None, :] * (m // 8)
    for base in (0, 1):                # the tensor's first float2, in units
        for c, f0, nb in sum(walks, []):
            a = base + (c * nf + f0) * bins
            lo, hi = a // 2 * 2, -(-(a + nb * bins) // 2) * 2
            assert hi - lo <= stage and stage % 2 == 0
            ring = np.full(stage, np.nan)
            ring[:hi - lo] = spec[lo:hi]
            for fb in range(nb):
                row = ring[a % 2 + fb * bins:]
                want = spec[a + fb * bins:a + (fb + 1) * bins]
                np.testing.assert_array_equal(row[k], want[k])
                np.testing.assert_array_equal(row[m - k], want[m - k])
