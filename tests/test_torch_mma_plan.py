"""The host side of the tensor-core product core (``csrc/mma_tiers.cuh``)
of the banded upfirdn and the windowed-DFT power: ``ops/mma_plan.py``'s
tier split, tile geometry, B operands in core-matrix layout and Hankel
index maps, replayed on the CPU.

- upfirdn: at every geometry the port launches (the chain head, the
  1024-tap FIR, resample_poly's ratios and the multistage stages), plus a
  ragged n_out, a positive offset and a signal shorter than one frame, the
  plan's band matrix, read back from its parts' core-matrix layout, and its
  Hankel map, pass by pass as the kernel stages A (depth chunks where B
  is streamed, copied rows where no window fits), give in float64 what
  ``upfirdn_tall`` and the function's definition give; also at the fused
  head's 8/7 and 5/7 and at 2,048 FIR taps, at 16,384 taps (B streamed)
  and at 1/1000 (A's rows copied).
- windowed-DFT power: the interleaved basis, read back from its tiles, and
  the row-stride-hop map give ``stft_power_dft_plain`` in float64; the
  kernel's depth order over its sample tiles (split over several tiles
  from q = 104) gives the same product, and its tiles fit a block and
  never overlap in flight.
- tiers: three bf16 parts sum back exactly to float32 values; an emulation
  of the kernels' tiers (hi*hi and the other products in two float32
  sums, bf16 values from torch's casts) stays below chip_smoke.py's
  UPFIRDN_PROBE_TOL on the tier probe's single products, lands beyond it
  against the neighbouring tier, and stays below 1e-5 of the plain
  versions on dense input, as the kernels must on the card; a model of
  the tensor cores' round-toward-zero sums shows why deep bands restart
  their hi*hi sum (the plan's flush).
"""

import numpy as np
import pytest
import torch

from vv_dsp_tpu_torch.ops import mma_plan as mp
from vv_dsp_tpu_torch.ops import resample as trs
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops import upfirdn as tuf
from vv_dsp_tpu_torch.ops.fir import design_lowpass_np

UPFIRDN_PROBE_TOL = 2.5e-7      # chip_smoke.py's tier probe limit
DENSE_TOL = 1e-5                # UPFIRDN_TOL and DFT_POWER_TOL
ALGORITHMS = ("f32", "bf16x3", "bf16")


def _chain_head():
    """The fused head's composite filter at 4/3 (1,044 taps a phase)."""
    from vv_dsp_tpu_torch.models import NorthStarChain
    h = NorthStarChain(device="cpu").fir_coeffs.astype(np.float64)
    return trs._fused_fir_resample_filter(tuple(h), 4, 3)


def _head(up, down, fir_taps):
    """The fused head of NorthStarChain(up, down, fir_taps)."""
    from vv_dsp_tpu_torch.models import NorthStarChain
    chain = NorthStarChain(up=up, down=down, fir_taps=fir_taps, device="cpu")
    h = chain.fir_coeffs.astype(np.float64)
    g, off = trs._fused_fir_resample_filter(tuple(h), up, down)
    return tuf.polyphase_table_np(g, up), up, down, off


def _geometry(name):
    """(table (up, taps_pp) float32, up, down, offset) of a launch."""
    if name == "chain":
        g, off = _chain_head()
        return tuf.polyphase_table_np(g, 4), 4, 3, off
    if name == "fir1024":
        return tuf.polyphase_table_np(design_lowpass_np(1024, 0.3), 1), 1, 1, 0
    if name in ("head_8_7", "head_5_7"):
        return _head(int(name[5]), 7, 1024)
    if name == "head_2048":
        return _head(4, 3, 2048)
    if name == "fir16384":       # B streamed in depth chunks
        return (tuf.polyphase_table_np(design_lowpass_np(16384, 0.3), 1),
                1, 1, 0)
    if name == "decimate1000":   # A's rows copied: no window fits
        g = design_lowpass_np(21, 0.0009)
        return tuf.polyphase_table_np(g, 1), 1, 1000, 10
    if name == "offset":
        g = trs._resample_poly_filter(4, 3)
        return tuf.polyphase_table_np(g, 4), 4, 3, 3 * len(g)
    up, down = name
    g = trs._resample_poly_filter(up, down)
    return tuf.polyphase_table_np(g, up), up, down, (len(g) - 1) // 2


LAUNCHED = ["chain", "fir1024", (2, 1), (1, 2), (4, 3), (8, 7), (5, 7),
            (7, 5), (3, 4), (31, 1), "offset"]
GEOMETRIES = LAUNCHED + ["head_8_7", "head_5_7", "head_2048", "fir16384",
                         "decimate1000"]


def _direct(x, table, up, down, offset, n_out):
    """y[c, k] = sum_j x[c, j] g[offset + k down - j up] in float64, the
    function's own definition (g[p + i up] = taps[p, i]): x zero-stuffed
    by up, np.convolve with g, read at offset + k down."""
    g = table.astype(np.float64).T.reshape(-1)
    t = offset + np.arange(n_out) * down
    out = np.zeros((x.shape[0], n_out))
    for c in range(x.shape[0]):
        u = np.zeros(x.shape[-1] * up)
        u[::up] = x[c]
        v = np.convolve(u, g)
        ok = t < len(v)
        out[c, ok] = v[t[ok]]
    return out


def _replay(x, plan, b, n_out):
    """The kernel's passes in float64: for each block of frames and depth
    chunk, the pass's A staged as csrc/upfirdn.cu stages it (element e is
    sample e after the pass's first in a window, e // a_pitch * stride +
    e % a_pitch where rows are copied; zero outside the signal),
    each lane's row read at its pitch, times the chunk's rows of B."""
    b = b[:, :plan.n_real]
    bm = 16 * plan.m_tiles * mp.UF_WARPS
    frames = -(-n_out // plan.n_real)
    c, n = x.shape
    y = np.zeros((c, -(-frames // bm) * bm, plan.n_real))
    e = np.arange(plan.win)
    if plan.a_pitch == plan.stride:
        sample = e
    else:
        sample = e // plan.a_pitch * plan.stride + e % plan.a_pitch
    rows = np.arange(bm)[:, None] * plan.a_pitch + np.arange(plan.k_chunk)
    assert rows.max() < plan.win
    for f0 in range(0, frames, bm):
        for k0 in range(0, plan.k_pad, plan.k_chunk):
            s = plan.c_lo + f0 * plan.stride + k0 + sample
            w = np.where((s >= 0) & (s < n), x[:, np.clip(s, 0, n - 1)], 0.0)
            y[:, f0:f0 + bm] += w[:, rows] @ b[k0:k0 + plan.k_chunk]
    return y.reshape(c, -1)[:, :n_out]


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_upfirdn_plan_replays_the_function(geom, algorithm):
    table, up, down, offset = _geometry(geom)
    plan = mp.upfirdn_plan(up, down, table.shape[1], offset, algorithm)
    assert plan.stride % 8 == 0 and plan.k_chunk % 16 == 0
    assert plan.k_pad % plan.k_chunk == 0
    assert plan.n_pad == 8 * plan.n_tiles * plan.col_blocks >= plan.n_real
    assert plan.n_tiles <= mp.MAX_N_TILES
    assert plan.m_tiles == 1 or plan.n_tiles * mp.PARTS[algorithm] <= 12
    assert (plan.flush > 0) == (plan.k_pad > mp.UF_FLUSH_DEPTH)
    assert plan.m_tiles == 1 or not plan.flush
    assert plan.a_pitch % 8 == 0
    assert plan.smem == mp.upfirdn_smem_bytes(
        mp.PARTS[algorithm], plan.n_tiles, plan.k_chunk, plan.win)
    assert plan.smem <= mp.SMEM_BYTES
    parts = mp.band_parts_np(table, plan, algorithm)
    assert parts.shape == (mp.PARTS[algorithm], plan.n_pad // 8,
                           plan.k_pad // 8, 8, 8)
    b32 = mp.band_matrix_np(table, plan).astype(np.float32)
    total = sum(mp.from_core_layout_np(q).astype(np.float64) for q in parts)
    if algorithm == "f32":
        np.testing.assert_array_equal(total, b32)   # exact, three parts
    # every tap lands once: the band holds the table and zeros
    assert np.count_nonzero(b32) == np.count_nonzero(
        table[(plan.offset + np.arange(plan.n_real) * down) % up])
    rng = np.random.default_rng(3)
    # the plain version's own frames, except where their matrix would be
    # the size of taps_pp squared
    group = None if table.shape[1] <= 2100 else plan.group
    for n, n_out in ((5001, -(-5001 * up // down)), (3001, 1000),
                     (7, -(-7 * up // down))):
        x = rng.standard_normal((2, n))
        want = _direct(x, table, up, down, offset, n_out)
        got = _replay(x, plan, mp.band_matrix_np(table, plan), n_out)
        scale = np.abs(want).max()
        if scale == 0:               # every output reads past the signal
            assert not got.any()
            continue
        assert np.abs(got - want).max() <= 1e-12 * scale
        tall = tuf.upfirdn_tall(torch.as_tensor(x),
                                torch.as_tensor(table, dtype=torch.float64),
                                up, down, offset, n_out, group=group).numpy()
        assert np.abs(tall - want).max() <= 1e-12 * scale


def test_upfirdn_plan_picks_the_designed_groups():
    """The chain head at 8 frames of 32 outputs (stride 24, k_pad 1,072:
    2.3% zero fill), B resident in one column block, two 16-row tiles a
    warp; every launch geometry a stride that is an odd multiple of 8
    where the ratio allows it; heads of 1,044-2,068 taps a phase keep B
    resident (in more column blocks where a slice must narrow); longer
    filters stream B in depth chunks, and a stride whose window no block
    holds copies A's rows: every plan fits a block."""
    table, up, down, offset = _geometry("chain")
    for algorithm in ALGORITHMS:
        p = mp.upfirdn_plan(up, down, table.shape[1], offset, algorithm)
        assert (p.group, p.n_real, p.stride, p.k_pad) == (8, 32, 24, 1072)
        assert (p.n_tiles, p.col_blocks, p.m_tiles) == (4, 1, 2)
        assert (p.k_chunk, p.a_pitch) == (p.k_pad, p.stride)
    for geom in LAUNCHED:
        table, up, down, offset = _geometry(geom)
        p = mp.upfirdn_plan(up, down, table.shape[1], offset, "f32")
        assert (p.stride // 8) % 2 == 1, geom
    for geom in ("head_8_7", "head_5_7", "head_2048"):
        table, up, down, offset = _geometry(geom)
        for algorithm in ALGORITHMS:
            p = mp.upfirdn_plan(up, down, table.shape[1], offset, algorithm)
            assert (p.k_chunk, p.a_pitch) == (p.k_pad, p.stride), geom
    p = mp.upfirdn_plan(8, 7, 1044, 0, "f32")
    assert (p.n_tiles, p.col_blocks) == (2, 4)
    for taps_pp, down in ((10_000, 3), (40_000, 3), (30_000, 1)):
        for algorithm in ALGORITHMS:
            p = mp.upfirdn_plan(4 if down == 3 else 1, down, taps_pp, 0,
                                algorithm)
            assert p.smem <= mp.SMEM_BYTES
            assert p.k_pad >= taps_pp and p.k_pad - taps_pp < p.k_pad / 4
    p = mp.upfirdn_plan(1, 1000, 21, 10, "f32")
    assert p.a_pitch == p.k_chunk + 8 and (p.a_pitch // 8) % 2 == 1


def _dft_replay(x, nfft, hop, nf):
    bre, bim = tsk._windowed_rfft_basis(nfft, "hann", None, "float32")
    parts = mp.dft_parts_np(bre, bim)
    assert parts.shape[:3] == (3, mp.dft_cols(nfft) // mp.DP_BN,
                               nfft // mp.DP_KC)
    b = sum(mp.from_dft_tiles_np(q).astype(np.float64) for q in parts)
    np.testing.assert_array_equal(b, mp.interleave_np(bre, bim,
                                                      b.shape[1]))
    idx = mp.dft_frame_index(nfft, hop, nf)
    a = np.where(idx < x.shape[-1], x[:, np.clip(idx, 0, x.shape[-1] - 1)],
                 0.0)
    spec = a @ b
    bins = nfft // 2 + 1
    assert not spec[..., 2 * bins:].any()
    return spec[..., 0:2 * bins:2] ** 2 + spec[..., 1:2 * bins:2] ** 2


@pytest.mark.parametrize("nfft,hop,n", [(1024, 256, 9001), (2048, 512, 9001),
                                        (1024, 1024, 9001), (384, 128, 5000),
                                        (2048, 512, 1500)])
def test_dft_plan_replays_the_power(nfft, hop, n):
    x = np.random.default_rng(nfft + hop).standard_normal((2, n))
    for nf in (None, 3):
        want = tsk.stft_power_dft_plain(torch.as_tensor(x), nfft, hop,
                                        n_frames=nf).numpy()
        got = _dft_replay(x, nfft, hop, want.shape[1])
        # the replay multiplies the float32 basis, the plain version the
        # float64 one: 2^-24 of each basis value
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


DFT_ORDER_GEOMETRIES = [(1024, 256), (1024, 1024), (2048, 1024), (384, 128),
                        (4096, 128), (8320, 128), (13312, 128),
                        (16512, 128), (32768, 256)]


@pytest.mark.parametrize("nfft,hop", DFT_ORDER_GEOMETRIES)
def test_dft_plan_tiles_fit_and_never_overlap(nfft, hop):
    """Every q = nfft/hop gets a layout that fits a block (one tile of
    128 + q - 1 rows up to q = 103, then the q chunks split over tiles);
    each stretch's chunks run through its tiles in order, each tile's rows
    hold its chunks' reads, and the tiles that start within DP_AHEAD
    chunks of each other (staged before the earlier is split) are never
    more than its raw sample buffers."""
    p = mp.dft_plan(nfft, hop)
    assert p.smem <= mp.SMEM_BYTES
    assert (p.tiles == 1) == (p.q <= 103)
    chunks = nfft // mp.DP_KC
    order = [mp.dft_chunk_tile(p, i) for i in range(chunks)]
    assert [o * p.q + r for o, r, _, _ in order] == list(range(chunks))
    starts = []
    for i, (o, r, tile, r0) in enumerate(order):
        assert 0 <= r - r0 and mp.DP_BM - 1 + r - r0 < p.rows
        if r == r0:
            starts.append(i)
            assert tile == len(starts) - 1
        else:
            assert tile == order[i - 1][2]
    for i in range(chunks):
        live = [t for t in starts if i < t <= i + mp.DP_AHEAD]
        assert len(live) <= p.raw_bufs


@pytest.mark.parametrize("nfft,hop", DFT_ORDER_GEOMETRIES)
def test_dft_kernel_order_replays_the_product(nfft, hop):
    """csrc/dft_power.cu's depth order in float64: per block of DP_BM
    frames and chunk, the chunk's tile staged from its rows' samples
    (zero past the signal), each frame's row read at r - r0, times the
    chunk's DP_KC rows of B, gives A @ B. B is random here: the basis's
    own replay is test_dft_plan_replays_the_power."""
    p = mp.dft_plan(nfft, hop)
    rng = np.random.default_rng(p.q)
    nf = mp.DP_BM + 21
    n = (nf - 1) * hop + nfft - 3 * hop // 2     # the last frames run past
    x = rng.standard_normal(n)
    b = rng.standard_normal((nfft, 8))
    per_hop = hop // mp.DP_KC
    got = np.zeros((-(-nf // mp.DP_BM) * mp.DP_BM, 8))
    for f_base in range(0, nf, mp.DP_BM):
        for i in range(nfft // mp.DP_KC):
            o, r, _, r0 = mp.dft_chunk_tile(p, i)
            s = ((f_base + r0 + np.arange(p.rows))[:, None] * hop
                 + o * mp.DP_KC + np.arange(mp.DP_KC))
            tile = np.where(s < n, x[np.clip(s, 0, n - 1)], 0.0)
            a = tile[np.arange(mp.DP_BM) + r - r0]
            kc = r * per_hop + o
            got[f_base:f_base + mp.DP_BM] += (
                a @ b[kc * mp.DP_KC:(kc + 1) * mp.DP_KC])
    idx = mp.dft_frame_index(nfft, hop, nf)
    want = np.where(idx < n, x[np.clip(idx, 0, n - 1)], 0.0) @ b
    np.testing.assert_allclose(got[:nf], want, rtol=0, atol=1e-9)


def test_three_bf16_parts_sum_back_to_float32():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(
        np.uint32)
    v = bits.view(np.float32)
    v = v[np.isfinite(v) & (np.abs(v) > 2.0 ** -100) & (np.abs(v) < 2.0 ** 120)]
    v = np.concatenate([v, np.float32([0.0, 1.0, -1.0, 1 + 2 ** -23,
                                       3.4e37, np.pi, 1 / 3])])
    hi, mid, lo = mp.split_parts_np(v, 3)
    assert np.array_equal(hi, torch.as_tensor(v).to(torch.bfloat16)
                          .float().numpy())
    for q in (hi, mid, lo):
        assert np.array_equal(q, mp.bf16_round_np(q))     # bf16 values
    s = hi.astype(np.float64) + mid + lo
    assert np.array_equal(s, v.astype(np.float64))
    # bf16x3's two parts keep 16 bits: its remainder is at most 2^-16 |v|
    rest = v.astype(np.float64) - hi - mid
    assert (np.abs(rest) <= 2.0 ** -16 * np.abs(v)).all()


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _tier_emulation(a, b, algorithm):
    """The kernels' arithmetic in float32: parts by torch's bf16 casts,
    hi*hi in one sum, the other products in another, added at the end."""
    parts = mp.PARTS[algorithm]
    pa, pb, ra, rb = [], [], a, b
    for _ in range(parts):
        pa.append(_bf16(ra))
        pb.append(_bf16(rb))
        ra, rb = ra - pa[-1], rb - pb[-1]
    main = pa[0] @ pb[0]
    corr = torch.zeros_like(main)
    for i, j in reversed(mp.PRODUCTS[algorithm][1:]):
        corr = corr + pa[i] @ pb[j]
    return main + corr


def _tall_operands(x, table, up, down, offset, n_out, plan):
    frames = -(-n_out // plan.n_real)
    idx = mp.hankel_index(plan, frames)
    xn = x.numpy()
    a = np.where((idx >= 0) & (idx < xn.shape[-1]),
                 xn[:, np.clip(idx, 0, xn.shape[-1] - 1)], 0.0)
    b = mp.band_matrix_np(table, plan)[:, :plan.n_real]
    return (torch.as_tensor(a, dtype=torch.float32),
            torch.as_tensor(b, dtype=torch.float32))


def _emulated_upfirdn(x, table, up, down, offset, n_out, algorithm):
    plan = mp.upfirdn_plan(up, down, table.shape[1], offset, algorithm)
    a, b = _tall_operands(x, table, up, down, offset, n_out, plan)
    y = _tier_emulation(a, b, algorithm)
    return y.reshape(x.shape[0], -1)[:, :n_out]


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_tier_emulation_on_the_upfirdn_probe(algorithm):
    """chip_smoke.py's tier probe at the chain head on 2 channels: one
    impulse per 1500 samples, so every output is a single product."""
    table, up, down, offset = _geometry("chain")
    x = np.zeros((2, 24000), np.float32)
    pos = np.arange(700, 24000, 1500)
    x[:, pos] = np.random.default_rng(1).standard_normal((2, len(pos)))
    x = torch.as_tensor(x)
    taps = torch.as_tensor(table)
    got = _emulated_upfirdn(x, table, up, down, offset, 32000, algorithm)
    for other in ALGORITHMS:
        want = tuf.upfirdn_tall(x, taps, up, down, offset, 32000, other)
        err = _rel(got, want)
        if other == algorithm:
            assert err < UPFIRDN_PROBE_TOL / 2, other
        elif {other, algorithm} == {"f32", "bf16x3"}:
            assert err > UPFIRDN_PROBE_TOL * 4, other     # the control


@pytest.mark.parametrize("geom", ["chain", (4, 3), (1, 2)])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_tier_emulation_on_dense_input(geom, algorithm):
    table, up, down, offset = _geometry(geom)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((2, 6000)),
                        dtype=torch.float32)
    n_out = -(-6000 * up // down)
    got = _emulated_upfirdn(x, table, up, down, offset, n_out, algorithm)
    want = tuf.upfirdn_tall(x, torch.as_tensor(table), up, down, offset,
                            n_out, algorithm)
    assert _rel(got, want) < DENSE_TOL / 4


def test_tier_emulation_of_the_dft_power():
    """The six-product f32 tier of the windowed-DFT power against its plain
    version, 1024/256, of max power."""
    nfft, hop = 1024, 256
    xn = np.random.default_rng(5).standard_normal((2, 20000)).astype(
        np.float32)
    want = tsk.stft_power_dft_plain(torch.as_tensor(xn), nfft, hop)
    nf = want.shape[1]
    bre, bim = tsk._windowed_rfft_basis(nfft, "hann", None, "float32")
    b = torch.as_tensor(mp.interleave_np(bre, bim, mp.dft_cols(nfft)),
                        dtype=torch.float32)
    idx = mp.dft_frame_index(nfft, hop, nf)
    a = torch.as_tensor(np.where(idx < xn.shape[-1],
                                 xn[:, np.clip(idx, 0, xn.shape[-1] - 1)],
                                 0.0), dtype=torch.float32)
    spec = _tier_emulation(a, b, "f32")[..., :2 * (nfft // 2 + 1)]
    got = spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2
    assert _rel(got, want) < DENSE_TOL / 10


def _rz32(v):
    """float64 -> float32, rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tensor_core_sum(a, b, algorithm, flush):
    """csrc/upfirdn.cu's sums of a @ b modelled: each 16-deep product adds
    into a float32 accumulator rounded toward zero, hi*hi into its own,
    restarted every `flush` steps (0: never) into a float32 total; and the
    tier's exact sum of the same products in float64."""
    parts = mp.PARTS[algorithm]
    pa = [p.astype(np.float64) for p in mp.split_parts_np(a, parts)]
    pb = [p.astype(np.float64) for p in mp.split_parts_np(b, parts)]
    n = a.shape[0]
    main, corr, total = (np.zeros(n, np.float32) for _ in range(3))
    exact = np.zeros(n)
    for s in range(a.shape[1] // 16):
        k = slice(16 * s, 16 * s + 16)
        for i, j in reversed(mp.PRODUCTS[algorithm][1:]):
            corr = _rz32(corr + pa[i][:, k] @ pb[j][k])
        main = _rz32(main + pa[0][:, k] @ pb[0][k])
        exact += sum(pa[i][:, k] @ pb[j][k] for i, j in mp.PRODUCTS[algorithm])
        if flush and s % flush == flush - 1:
            total, main = total + main, np.zeros(n, np.float32)
    return (total + main) + corr, exact


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_flush_bounds_the_tensor_cores_rounding(algorithm):
    """Why a band deeper than UF_FLUSH_DEPTH restarts its hi*hi sum: in the
    model of the tensor cores' round-toward-zero accumulation, one running
    sum over a 16,384-tap FIR (k_pad 16,448) errs beyond UPFIRDN_TOL (the
    card read 2.4e-5 at f32 before the kernel flushed) and the plan's flush
    holds it below a quarter of it; at 1,900 taps (k_pad below
    UF_FLUSH_DEPTH: one sum) it stays below half of it. Of max |y|, against
    the tier's exact sum."""
    rng = np.random.default_rng(11)
    for taps, deep in ((16384, True), (1900, False)):
        p = mp.upfirdn_plan(1, 1, taps, 0, algorithm)
        assert (p.flush > 0) == deep
        h = design_lowpass_np(taps, 0.3).astype(np.float32)
        x = rng.standard_normal(256 + taps).astype(np.float32)
        k16 = -(-taps // 16) * 16
        a = np.zeros((256, k16), np.float32)
        a[:, :taps] = x[np.arange(256)[:, None] + taps - 1 - np.arange(taps)]
        b = np.zeros(k16, np.float32)
        b[:taps] = h
        one, exact = _tensor_core_sum(a, b, algorithm, 0)
        err = np.abs(one - exact).max() / np.abs(exact).max()
        if deep:
            if algorithm == "f32":
                assert err > DENSE_TOL
            got, _ = _tensor_core_sum(a, b, algorithm, p.flush)
            assert np.abs(got - exact).max() / np.abs(exact).max() < (
                DENSE_TOL / 4)
        else:
            assert err < DENSE_TOL / 2
