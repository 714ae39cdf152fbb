"""The per-phase polyphase kernel (``csrc/filter.cu poly_kernel``) replayed
in numpy float64 with its own index maps and its host plan
(``ops/poly_plan.py``), on the CPU.

The replay runs each block of a persistent grid as the kernel does, on a
model of its shared memory (ws, os, two window buffers and ys at the
plan's offsets, every word NaN until written, so a read of a word no copy
wrote shows in the output); block b walks tiles b, b + grid, ..., the
it-th in buffer it mod 2, tile t being frames (t mod per_row) * frames ..
of row t div per_row:
- the window: warp w, lane l < g_in * down copies row l mod down, column
  w g_in + l div down (+ warps g_in per run) from x[(q0 + lo + j) down +
  r], zero outside the signal;
- warp w takes items w, w + warps, ... of the tile's (phase s, group g),
  item i = g up + s; lane l owns frames f0 = (g 32 + l) POLY_R ..; for
  each class ci of phase s it loads POLY_R + K - 1 row words from
  os[s ncls + ci] + f0 and the class's taps, and writes its sums at
  ys[s p_pitch + f0 + j];
- the stores: lane l < g_out * up takes phase l mod up of frame
  w g_out + l div up (+ warps g_out per run), output q0 up + f up + s
  below n_out.

It checks that every output is written once, that each warp's copies,
window reads, staging writes and staged reads fall on 32 distinct banks
(one word a lane), that a warp's stores are one run of consecutive outputs,
and the result: against float64 ``scipy.signal.resample_poly`` at 1e-12 of
max |y| (ragged n_out, n_in below taps_pp, windows past both ends), and
against the JAX package's ``resample_poly_pallas`` in interpret mode at
``RESAMPLE_TOL``. The plan is checked on all 377 geometries
``resample_poly_kernel`` sends to the kernel, each also replayed on one
short signal against scipy.
"""

import numpy as np
import pytest
import torch
from scipy import signal as ss

from vv_dsp_tpu.ops import pallas_kernels as jpk
from vv_dsp_tpu_torch import _build
from vv_dsp_tpu_torch.ops import filter_kernels as tfk
from vv_dsp_tpu_torch.ops import poly_plan as pp

EXACT_TOL = 1e-12
RESAMPLE_TOL = 1e-5
RATIOS = [(2, 1), (1, 2), (4, 3), (3, 4), (7, 5), (1, 25), (24, 1),
          (24, 23)]


def _banks_distinct(addrs) -> bool:
    addrs = np.asarray(addrs)
    return len(np.unique(addrs % 32)) == len(addrs)


def replay(p: pp.PolyPlan, x: np.ndarray, counts: np.ndarray | None = None,
           check_banks: bool = True, grid: int = 3) -> np.ndarray:
    """poly_kernel on x (c, n_in) in float64: `grid` persistent blocks,
    block b walking tiles b, b + grid, ..., its it-th tile in window
    buffer it % 2."""
    c_all, n_in = x.shape
    up, down, kp, r_ = p.up, p.down, p.kp, pp.POLY_R
    n_out = -(-n_in * up // down)
    frames, warps = p.frames, p.threads // 32
    n_cls = up * p.ncls
    words = p.smem // 4
    ws_at, os_at = 0, n_cls * kp
    xs_at = (os_at + n_cls, os_at + n_cls + down * p.q_pitch)
    ys_at = xs_at[1] + down * p.q_pitch
    assert ys_at + up * p.p_pitch == words
    y = np.full((c_all, n_out), np.nan)
    per_row = -(-(-(-n_out // up)) // frames)
    tiles = per_row * c_all
    lanes = np.arange(32)
    g_in, g_out = 32 // down, 32 // up
    for b in range(min(grid, tiles)):
        sm = np.full(words, np.nan)
        sm[ws_at:os_at] = p.weights
        sm[os_at:xs_at[0]] = p.offsets
        for it, t in enumerate(range(b, tiles, grid)):
            c, q0 = t // per_row, (t % per_row) * frames
            xs = xs_at[it % 2]
            # the window's copy, by whole columns
            r, g = lanes % down, lanes // down
            act = g < g_in
            for w in range(warps):
                for j0 in range(w * g_in, p.row_len, warps * g_in):
                    j = j0 + g[act]
                    keep = j < p.row_len
                    rr, j = r[act][keep], j[keep]
                    src = (q0 + p.lo + j) * down + rr
                    ok = (src >= 0) & (src < n_in)
                    dst = xs + rr * p.q_pitch + j
                    assert (dst >= xs).all()
                    assert (dst < xs + down * p.q_pitch).all()
                    if check_banks:
                        assert _banks_distinct(dst)
                    sm[dst] = np.where(ok, x[c, np.clip(src, 0, n_in - 1)],
                                       0.0)
            # the sums: warp w takes items w, w + warps, ... (item i is
            # phase i % up of group i // up); lane l frames
            # (g*32 + l)*POLY_R + j
            items = [(w, i) for w in range(warps)
                     for i in range(w, up * frames // pp.GROUP, warps)]
            for w, item in items:
                g, s = divmod(item, up)
                f0 = (g * 32 + lanes) * r_
                acc = np.zeros((32, r_))
                for ci in range(p.ncls):
                    cls = s * p.ncls + ci
                    k = p.k if ci < p.n_big else p.k - 1
                    win_len = r_ + k - 1
                    src = xs + int(sm[os_at + cls]) + f0
                    idx = src[:, None] + np.arange(win_len)[None, :]
                    assert (idx >= xs).all()
                    assert (idx < xs + down * p.q_pitch).all()
                    if check_banks:
                        for v in range(win_len):
                            assert _banks_distinct(idx[:, v])
                    win = sm[idx]
                    h = sm[ws_at + cls * kp:ws_at + cls * kp + kp]
                    for kk in range(k):
                        acc += h[kk] * win[:, k - 1 - kk:k - 1 - kk + r_]
                dst = ys_at + s * p.p_pitch + f0[:, None] + np.arange(r_)
                assert (dst < words).all()
                if check_banks:
                    for jj in range(r_):
                        assert _banks_distinct(dst[:, jj])
                sm[dst] = acc
            # the stores, by whole frames
            s_, g = lanes % up, lanes // up
            act = g < g_out
            for w in range(warps):
                for fb in range(w * g_out, frames, warps * g_out):
                    f = fb + g[act]
                    ss_ = s_[act][f < frames]
                    f = f[f < frames]
                    src = ys_at + ss_ * p.p_pitch + f
                    if check_banks:
                        assert _banks_distinct(src)
                    m = q0 * up + f * up + ss_
                    assert (np.diff(m) == 1).all()
                    keep = m < n_out
                    y[c, m[keep]] = sm[src[keep]]
                    if counts is not None:
                        np.add.at(counts[c], m[keep], 1)
    return y


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(
        want).max()


@pytest.mark.parametrize("up,down", RATIOS)
@pytest.mark.parametrize("n", [7, 1000, 2333])
def test_replay_matches_scipy(up, down, n):
    """Ragged n_out, n_in below taps_pp (n = 7), signals shorter than one
    tile (the window past both ends) and several tiles walked by 3 blocks,
    each alternating its two window buffers (n = 2333: 7 tiles of 352
    frames a row at 2/1 and 24/1, 3 at 4/3)."""
    x = np.random.default_rng(up * 100 + down).standard_normal((2, n))
    p = pp.poly_plan(up, down)
    n_out = -(-n * up // down)
    counts = np.zeros((2, n_out), np.int64)
    got = replay(p, x, counts, check_banks=n == 1000)
    assert (counts == 1).all()
    want = ss.resample_poly(x, up, down, axis=-1)
    assert got.shape == want.shape
    assert _rel(got, want) < EXACT_TOL


@pytest.mark.parametrize("up,down", [(4, 3), (3, 4), (7, 5), (1, 2),
                                     (2, 1)])
def test_replay_matches_pallas_kernel(up, down):
    x = np.random.default_rng(3).standard_normal((3, 1500)).astype(
        np.float32)
    want = np.asarray(jpk.resample_poly_pallas(x, up, down, q_tile=64,
                                               interpret=True))
    got = replay(pp.poly_plan(up, down), x.astype(np.float64),
                 check_banks=False)
    assert _rel(got, want) < RESAMPLE_TOL


def test_plan_at_every_geometry():
    """All 377 geometries: an instance at least each class's length, a
    layout within a block's 227 KB, windows inside their residue rows; each
    replayed on a signal shorter than its filter's span against scipy."""
    geoms = pp.kernel_geometries()
    assert len(geoms) == 377
    assert max(u for u, _ in geoms) == 24 and max(d for _, d in geoms) == 25
    x = np.random.default_rng(5).standard_normal((1, 61))
    for up, down in geoms:
        p = pp.poly_plan(up, down)
        assert p.k in pp.K_INSTANCES and p.k == -(-p.taps_pp // down)
        assert (p.n_big == p.ncls if p.k == 1
                else p.n_big == p.taps_pp - (p.k - 1) * down)
        assert p.smem <= pp.SMEM_BYTES
        assert p.ncls == min(down, p.taps_pp)
        assert p.q_pitch >= p.row_len and p.p_pitch >= p.frames
        cols = (p.offsets % p.q_pitch).reshape(up, p.ncls)
        n_c = np.where(np.arange(p.ncls) < p.n_big, p.k, p.k - 1)
        assert (cols >= 0).all()
        assert (cols + p.frames + n_c - 1 <= p.row_len).all()
        got = replay(p, x, check_banks=False)
        want = ss.resample_poly(x, up, down, axis=-1)
        assert _rel(got, want) < EXACT_TOL, (up, down)


def test_plan_weights_are_the_polyphase_taps():
    """Class (r, i_r) of phase s holds hpp[p_s, i_r::down] and zeros after
    them, its n_big classes of K taps first; the classes of a phase take
    each of its taps once."""
    for up, down in RATIOS:
        p = pp.poly_plan(up, down)
        h = tfk._resample_poly_filter(up, down)
        h_pad = np.zeros(up * p.taps_pp)
        h_pad[:len(h)] = h
        hpp = h_pad.reshape(p.taps_pp, up).T
        w = p.weights.reshape(up, p.ncls, p.kp)
        for s, (row, cls) in enumerate(pp.phase_classes(
                up, down, p.half_len, p.taps_pp)):
            taken = []
            for ci, (_, i_r, _, n) in enumerate(cls):
                taps = hpp[row, i_r::down]
                assert len(taps) == n == (p.k if ci < p.n_big else p.k - 1)
                assert np.array_equal(w[s, ci, :n], taps)
                assert not w[s, ci, n:].any()
                taken += range(i_r, p.taps_pp, down)
            assert sorted(taken) == list(range(p.taps_pp))


def test_row_chunks():
    """The wrappers' launches over rows: one up to 65,535, then one a run
    of at most 65,535, with pointers to each run's first row."""
    assert _build.row_chunks(1) == [(0, 1)]
    assert _build.row_chunks(65535) == [(0, 65535)]
    assert _build.row_chunks(65536) == [(0, 65535), (65535, 1)]
    assert _build.row_chunks(140000) == [(0, 65535), (65535, 65535),
                                         (131070, 8930)]
    with pytest.raises(ValueError):
        _build.row_chunks(0)
    t = torch.zeros((5, 3, 7), dtype=torch.complex64)
    assert _build.ptr(t, 2).value == t[2].data_ptr()
    assert _build.ptr(t).value == t.data_ptr()


@pytest.mark.parametrize("channels", [1, 65535, 65536, 140000])
def test_launch_walks_the_row_chunks(channels, monkeypatch):
    """_build.launch, the wrappers' one launch frame, with a stand-in for a
    kernel entry: one call a run of row_chunks, in order, each counted in
    the wrapper's launches; an entry's error raises under its name."""
    @_build.counted
    def wrapper():
        pass

    runs = _build.row_chunks(channels)
    calls = []
    n = _build.launch(wrapper, channels,
                      lambda r0, k: calls.append((r0, k)) or 0)
    assert calls == runs and n == len(runs) == wrapper.launches

    class Lib:     # the error strings, without the kernel library
        @staticmethod
        def vv_error_string(err):
            return b"an error string"

    monkeypatch.setattr(_build, "library", lambda: Lib)
    calls.clear()
    with pytest.raises(RuntimeError, match=r"^wrapper: CUDA error 700 "):
        _build.launch(wrapper, channels,
                      lambda r0, k: calls.append((r0, k)) or 700)
    assert calls == runs[:1] and wrapper.launches == len(runs)
