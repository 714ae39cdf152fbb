"""The two power kernels on the register-resident FFT (``csrc/stft.cu
stft_power_kernel``, ``csrc/stockham.cu stockham_power_kernel``), replayed
in float64 with the kernels' own index maps.

Packed (M = nfft/2 points, M/8 threads a frame, FB = 2048/M frames a
group): thread j loads points p = j + s M/8 (s < 8) of the packed frame,
z[p] = w[2p] x[2p] + i w[2p+1] x[2p+1] with its window pairs (w[2p],
w[2p+1]), zero past the signal and for frames past nf (``packed.cuh
packed_frame_regs``: the 8-byte load where the frame lies inside the signal
at an even float offset and two scalar loads otherwise read the same
values); the forward passes of ``csrc/fft_reg.cuh``
(``torch_fft_replay.replay_fft``); then bin k = 0..M of each frame below
nf, unpacked from Z[k mod M] and Z[(M - k) mod M] with wk[k] = exp(-2 pi i
k / nfft) (``unpack_bin``), and its re^2 + im^2.

Full-nfft (N = nfft points, FB = 4096/N frames a group, two to a
transform): thread j of a pair loads points j + s N/8 of z = w (x_f + i
x_f+1) / 2; from p = Z[k] and r = Z[(N - k) mod N], k = 0..N/2, frame f's
bin is (u, t) = (p.x + r.x, p.y - r.y) and frame f + 1's is (t, -u) with
(u, t) = (p.x - r.x, p.y + r.y); each writes u^2 + t^2.

Both write a group's rows, the group's frames below nf times the bins, as
one run at ((c nf + f0) bins); the runs of the persistent grid's groups
cover each (channel, frame, bin) of the output once.

Tolerances, of the reference's max power: the replays against numpy's
float64 ``rfft``, 1e-12; against the float32 plain versions
``stft_power_plain`` / ``stft_power_stockham_plain``, 5e-5 (the kernels'
contract on the card, ``POWER_TOL`` and ``STOCKHAM_TOL``).
"""

import numpy as np
import pytest
import torch

from torch_fft_replay import replay_fft
from vv_dsp_tpu_torch.ops import fft_plan
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops import stockham_kernels as tstk
from vv_dsp_tpu_torch.ops.framing import stft_num_frames
from vv_dsp_tpu_torch.ops.stft import STFT

POWER_TOL = 5e-5
EXACT_TOL = 1e-12
# every instance of each kernel, with an odd hop (packed: any hop the
# wrapper takes), hop == nfft, and the main rows 1024/256 and 128/32
PACKED = [(256, 64), (256, 256), (512, 128), (1024, 256), (1024, 255),
          (2048, 300), (2048, 512), (4096, 1024), (4096, 4096)]
FULL = [(128, 32), (128, 8), (128, 128), (256, 8), (256, 64), (512, 8),
        (1024, 8), (2048, 16), (2048, 2048)]


def _frame(x, f, nfft, hop, nf):
    """Frame f of x as the kernels load it: zero past the signal and for
    f >= nf."""
    seg = np.zeros(nfft)
    if f < nf:
        part = x[f * hop:f * hop + nfft]
        seg[:len(part)] = part
    return seg


def _points(n):
    """p[j, s] = j + s n/8, the points thread j holds; every point once."""
    t = n // 8
    p = np.arange(t)[:, None] + np.arange(8)[None, :] * t
    assert np.array_equal(np.sort(p.ravel()), np.arange(n))
    return p


def _packed_replay(x, nfft, hop, win):
    """The packed power kernel on one channel in float64, group by group:
    (nf, M + 1) powers. Frames of a group past nf transform to zeros."""
    m = nfft // 2
    n, fb = len(x), fft_plan.FR_POINTS // m
    nf = stft_num_frames(n, nfft, hop)
    p = _points(m)
    k = np.arange(m + 1)
    wk = np.exp(-2j * np.pi * k / nfft)
    rows = []
    for f0 in range(0, nf, fb):
        for q in range(fb):
            seg = _frame(x, f0 + q, nfft, hop, nf)
            v = np.empty(m, complex)
            v[p] = (win[2 * p] * seg[2 * p]
                    + 1j * win[2 * p + 1] * seg[2 * p + 1])
            z = replay_fft(v, m)
            if f0 + q >= nf:
                assert not z.any()
                continue
            a, b = z[k & (m - 1)], z[(m - k) & (m - 1)]
            e, o = (a + np.conj(b)) / 2, (a - np.conj(b)) / 2j
            xk = e + wk * o
            rows.append(xk.real ** 2 + xk.imag ** 2)
    return np.array(rows)


def _paired_replay(x, nfft, hop, win):
    """The full-nfft power kernel on one channel in float64, group by
    group, two frames a transform: (nf, N/2 + 1) powers."""
    n, fb = len(x), 2 * fft_plan.FR_POINTS // nfft
    nf = stft_num_frames(n, nfft, hop)
    p = _points(nfft)
    k = np.arange(nfft // 2 + 1)
    rows = []
    for f0 in range(0, nf, fb):
        for pair in range(fb // 2):
            f = f0 + 2 * pair
            z0 = 0.5 * win * (_frame(x, f, nfft, hop, nf)
                              + 1j * _frame(x, f + 1, nfft, hop, nf))
            v = np.empty(nfft, complex)
            v[p] = z0[p]
            z = replay_fft(v, nfft)
            pk, r = z[k], z[(nfft - k) & (nfft - 1)]
            for q in (0, 1):
                if f + q >= nf:
                    continue
                sg = -1.0 if q else 1.0
                u, t = pk.real + sg * r.real, pk.imag - sg * r.imag
                rows.append(u * u + t * t)
    return np.array(rows)


def _signal(nfft, hop, short, seed):
    """One frame of fewer than nfft samples, or 2 FB + 1 frames (FB =
    4096/nfft at both kernels' nfft: three groups, the last of one frame)
    with a ragged tail."""
    nf = 1 if short else 8192 // nfft + 1
    n = nfft // 2 + 3 if short else nfft + hop * (nf - 2) + 5
    assert stft_num_frames(n, nfft, hop) == nf
    return np.random.default_rng(seed).standard_normal((2, n))


def _check(got, x64, nfft, hop, win64, plain):
    """The replay of each channel against float64 rfft and the float32
    plain version."""
    for c, row in enumerate(x64):
        nf = stft_num_frames(len(row), nfft, hop)
        frames = np.stack([_frame(row, f, nfft, hop, nf) for f in range(nf)])
        want = np.abs(np.fft.rfft(frames * win64, axis=1)) ** 2
        assert got[c].shape == want.shape
        scale = want.max()
        assert np.abs(got[c] - want).max() < EXACT_TOL * scale
        assert np.abs(got[c] - plain[c]).max() < POWER_TOL * scale


@pytest.mark.parametrize("nfft,hop", PACKED)
@pytest.mark.parametrize("short", [False, True])
def test_packed_power_replay_is_the_power_spectrum(nfft, hop, short):
    """Every M = 128..2048, odd hops (1024/255, 2048/300: the 8-byte load
    off an even float offset), hop == nfft, n < nfft and an odd frame
    count."""
    x = _signal(nfft, hop, short, nfft + hop)
    x32 = torch.as_tensor(x, dtype=torch.float32)
    win = STFT(nfft, hop).win("cpu")
    plain = tsk.stft_power_plain(x32, nfft, hop, win).double().numpy()
    x64, win64 = x32.double().numpy(), win.double().numpy()
    got = [_packed_replay(row, nfft, hop, win64) for row in x64]
    _check(got, x64, nfft, hop, win64, plain)


@pytest.mark.parametrize("nfft,hop", FULL)
@pytest.mark.parametrize("short", [False, True])
def test_paired_power_replay_is_the_power_spectrum(nfft, hop, short):
    """Every N = 128..2048 on stockham_supported's lattice, hop == nfft,
    n < nfft and an odd frame count, whose last pair's second frame lies
    past nf."""
    x = _signal(nfft, hop, short, nfft + hop + 1)
    x32 = torch.as_tensor(x, dtype=torch.float32)
    win = STFT(nfft, hop).win("cpu")
    plain = tstk.stft_power_stockham_plain(x32, nfft, hop,
                                           win).double().numpy()
    x64, win64 = x32.double().numpy(), win.double().numpy()
    got = [_paired_replay(row, nfft, hop, win64) for row in x64]
    _check(got, x64, nfft, hop, win64, plain)


def _runs(channels, nf, bins, fb):
    """Each group's output run (start, length) as the persistent grid walks
    them: group g of channel c = g div per_row starts at frame f0 = (g mod
    per_row) FB and writes min(FB, nf - f0) rows of bins at
    (c nf + f0) bins."""
    per_row = -(-nf // fb)
    runs = []
    for g in range(per_row * channels):
        c = g // per_row
        f0 = (g - c * per_row) * fb
        runs.append(((c * nf + f0) * bins, min(fb, nf - f0) * bins))
    return runs


@pytest.mark.parametrize("kind,n", [("packed", n) for n in
                                    (128, 256, 512, 1024, 2048)]
                         + [("full", n) for n in (128, 256, 512, 1024, 2048)])
def test_group_runs_cover_the_output_once(kind, n):
    """1 and 3 channels, frame counts 1, FB - 1, FB, FB + 1 and an odd
    count over several groups: every (channel, frame, bin) of the output
    is written by exactly one group."""
    fb = fft_plan.FR_POINTS // n if kind == "packed" else 2 * (
        fft_plan.FR_POINTS // n)
    bins = n + 1 if kind == "packed" else n // 2 + 1
    for channels in (1, 3):
        for nf in sorted({1, max(fb - 1, 1), fb, fb + 1, 7 * fb + 3}):
            count = np.zeros(channels * nf * bins, int)
            for start, length in _runs(channels, nf, bins, fb):
                assert length > 0
                count[start:start + length] += 1
            assert (count == 1).all(), (channels, nf)
