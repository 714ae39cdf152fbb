"""Host side of the tensor-core product core (``csrc/mma_tiers.cuh``) of
the banded upfirdn (``csrc/upfirdn.cu``) and the windowed-DFT power
(``csrc/dft_power.cu``): the tiers as bf16 operand parts, each kernel's
tile geometry, its B operand laid out for the tensor cores and the Hankel
index map of its A operand.

Tiers. A float32 value v splits into bf16 parts, each rounded to nearest
even: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid); the three
sum back to v exactly. A product of two bf16 values is exact in float32,
so a tier rounds only at the split and in the sum, as on the TPU:

    bf16     1 part   hi*hi
    bf16x3   2 parts  hi*hi + hi*lo + lo*hi   (lo = bf16(v - hi))
    f32      3 parts  hi*hi + hi*mid + mid*hi + hi*lo + lo*hi + mid*mid

(``PRODUCTS`` lists them as (A part, B part) pairs, hi*hi first). The
kernels sum hi*hi in one float32 accumulator and the other products in a
second, added once at the end.

Both kernels are C = A @ B with A a Hankel view of the signal: row f of A
starts ``stride`` samples after row f - 1 and the rows overlap. B is built
here, in float64 from the float32 constants, split into its parts and
cast once; its parts are laid out as the tensor cores' 8 x 8 core
matrices (``core_layout_np``): for an (K, N) matrix, core matrix (ng, kg)
holds rows n = 8 ng .. 8 ng + 7, each the 8 depths k = 8 kg .. 8 kg + 7,
16 contiguous bytes a row, so one ``ldmatrix`` row is one n.

upfirdn. Outputs run in frames of ``n_real = group * up``: output
k = f * n_real + n reads its newest sample at anchor_n + f * stride
(stride = group * down) with phase p_n, the same for every frame, so

    y[f * n_real + n] = sum_j x[c_lo + f * stride + j] * B[j, n],
    B[j, n] = taps[p_n, anchor_n - c_lo - j]  (0 where that is no tap),

with c_lo = anchor_0 - (taps_pp - 1) and j < k_pad (``upfirdn_tall``'s
block-banded matrix, with the group chosen for the tensor cores). The
plan also fixes the kernel's whole layout (``upfirdn_plan``): column
blocks, 16-row tiles a warp, depth chunks where B cannot stay resident,
and A's pitch in shared memory; the kernel only dispatches on it.

windowed-DFT power. A[f, j] = x[f * hop + j], j < nfft; B interleaves the
windowed r2c basis's columns, B[j, 2k] = Re, B[j, 2k + 1] = Im, so a
thread holds both parts of a bin in adjacent accumulator registers.
``dft_plan`` splits the q = nfft / hop chunks a staged sample tile serves
over as few tiles as fit a block.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from vv_dsp_tpu_torch.utils.tensor_cache import PerTensor

# the kernels' tier codes (config.ALGORITHMS order) and their part counts
PARTS = {"f32": 3, "bf16x3": 2, "bf16": 1}
PRODUCTS = {
    "bf16": ((0, 0),),
    "bf16x3": ((0, 0), (0, 1), (1, 0)),
    "f32": ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1)),
}
SMEM_BYTES = 232448          # shared memory one Hopper block may hold
MAX_N_TILES = 8              # csrc/upfirdn.cu instantiates 1..8 n8 tiles
UF_WARPS = 4                 # csrc/upfirdn.cu's warps a block (16 rows each)
UF_FLUSH_DEPTH = 2048        # deeper bands restart the hi*hi sum ...
UF_FLUSH_STEPS = 64          # ... every 64 16-deep steps
DP_BM, DP_BN, DP_KC = 128, 96, 32    # csrc/dft_power.cu's block tile
DP_AHEAD, DP_BBUFS = 3, 5            # its chunks in flight, B buffers


def bf16_round_np(v) -> np.ndarray:
    """float32 -> the nearest bf16 value (ties to even), as float32."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
    return (u & np.uint32(0xFFFF0000)).view(np.float32)


def split_parts_np(v, parts: int) -> list[np.ndarray]:
    """The tier's bf16 parts of float32 values, each as float32: [hi],
    [hi, lo] or [hi, mid, lo]; each residual is exact in float32."""
    rest = np.asarray(v, dtype=np.float32)
    out = []
    for _ in range(parts):
        p = bf16_round_np(rest)
        out.append(p)
        rest = (rest - p).astype(np.float32)
    return out


def core_layout_np(b: np.ndarray) -> np.ndarray:
    """(K, N) -> (N/8, K/8, 8, 8): core matrix (ng, kg), row r = n, col c
    = k (K and N multiples of 8)."""
    k, n = b.shape
    return np.ascontiguousarray(
        b.reshape(k // 8, 8, n // 8, 8).transpose(2, 0, 3, 1))


def from_core_layout_np(c: np.ndarray) -> np.ndarray:
    """Inverse of core_layout_np."""
    ng, kg = c.shape[:2]
    return c.transpose(1, 3, 0, 2).reshape(kg * 8, ng * 8)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class UpfirdnPlan(NamedTuple):
    up: int
    down: int
    offset: int
    taps_pp: int
    group: int        # frames of group * up outputs
    n_real: int       # outputs a frame
    n_tiles: int      # n8 column tiles a block
    col_blocks: int   # blocks across the columns
    n_pad: int        # 8 * n_tiles * col_blocks >= n_real
    stride: int       # input samples between frames, group * down
    k_pad: int        # depth, a multiple of k_chunk
    k_chunk: int      # depth a pass; k_pad where B stays resident
    m_tiles: int      # 16-row tiles a warp
    flush: int        # 16-deep steps a hi*hi sum; 0: one over the depth
    a_pitch: int      # elements between A's rows in shared memory
    win: int          # elements of one part of A in shared memory
    smem: int         # dynamic shared memory of a block, bytes
    c_lo: int         # sample of A[0, 0]


def _upfirdn_geometry(up, down, taps_pp, offset, group):
    """(n_real, stride, k16, c_lo) of frames of `group` phases' cycles:
    k16 the band's depth rounded up to 16."""
    n_real = group * up
    t = offset + np.arange(n_real, dtype=np.int64) * down
    anchor = t // up
    c_lo = int(anchor[0]) - (taps_pp - 1)
    k = int(anchor[-1]) - c_lo + 1
    return n_real, group * down, _round_up(k, 16), c_lo


def _a_layout(stride: int, k_chunk: int, m_tiles: int,
              hankel: bool) -> tuple[int, int]:
    """(a_pitch, win) of A in shared memory: a Hankel window of the
    block's 16 * m_tiles * UF_WARPS frames (a_pitch = stride, rows
    overlapping), or each row copied (a_pitch = k_chunk + 8, an odd number
    of 16-byte units, so ldmatrix's 8 rows hit 8 distinct bank groups)."""
    pitch = stride if hankel else k_chunk + 8
    bm = 16 * m_tiles * UF_WARPS
    return pitch, _round_up((bm - 1) * pitch + k_chunk, 8)


def upfirdn_smem_bytes(parts: int, n_tiles: int, k_chunk: int,
                       win: int) -> int:
    """csrc/upfirdn.cu's shared memory: a block's column slice of a depth
    chunk of B's parts and its A, both in parts."""
    return 2 * parts * (n_tiles * k_chunk * 8 + win)


def _column_splits(n8: int):
    """(n_tiles, col_blocks) with the frame's n8 tiles balanced over the
    blocks, widest first."""
    for n_tiles in range(min(n8, MAX_N_TILES), 0, -1):
        col_blocks = -(-n8 // n_tiles)
        if -(-n8 // col_blocks) == n_tiles:
            yield n_tiles, col_blocks


def _largest_k_chunk(parts, n_tiles, stride, m_tiles, hankel, k16):
    """The deepest chunk (a multiple of 16, at most k16) whose layout fits
    a block, or 0."""
    bm, room = 16 * m_tiles * UF_WARPS, SMEM_BYTES // (2 * parts)
    if hankel:
        k_chunk = (room - (bm - 1) * stride) // (8 * n_tiles + 1)
    else:
        k_chunk = (room - 8 * (bm - 1)) // (8 * n_tiles + bm)
    k_chunk = min(k16, k_chunk // 16 * 16)
    while k_chunk >= 16:
        win = _a_layout(stride, k_chunk, m_tiles, hankel)[1]
        if upfirdn_smem_bytes(parts, n_tiles, k_chunk, win) <= SMEM_BYTES:
            return k_chunk
        k_chunk -= 16
    return 0


def upfirdn_plan(up: int, down: int, taps_pp: int, offset: int,
                 algorithm: str) -> UpfirdnPlan:
    """The kernel's tile geometry for one launch (``_upfirdn_search``);
    raises where no layout fits a block (``upfirdn_fits`` is False)."""
    p = _upfirdn_search(up, down, taps_pp, offset, algorithm)
    if p is None:
        raise ValueError(f"upfirdn_plan: no layout of {up}/{down} with "
                         f"{taps_pp} taps a phase fits a block")
    return p


def upfirdn_fits(up: int, down: int, taps_pp: int, offset: int,
                 algorithm: str) -> bool:
    """Whether the kernel has a layout for this geometry: the search of
    ``upfirdn_plan``, without raising. Every geometry of realistic size
    has one (at worst one column tile a block, a 16-deep chunk and A's rows
    copied: 9,936 bytes of shared memory at the f32 tier)."""
    return _upfirdn_search(up, down, taps_pp, offset, algorithm) is not None


@functools.lru_cache(maxsize=64)
def _upfirdn_search(up: int, down: int, taps_pp: int, offset: int,
                    algorithm: str) -> UpfirdnPlan | None:
    """The kernel's tile geometry for one launch, or None.

    Frames: A's rows must start on 16-byte boundaries for ldmatrix, so
    stride = group * down is a multiple of 8; an odd multiple keeps the 8
    rows of an ldmatrix on 8 distinct bank groups. Groups are tried up to
    64 outputs a frame (only the least where a frame is wider).

    B resident: where a block can hold its column slice of B whole (at
    any split of the frame's n8 tiles over blocks of columns; A as a
    Hankel window, else as copied rows), the layout with the fewest
    multiply-adds an output wins (k_pad * n_pad / n_real, zero fill
    included, times 1 + 1/(2 n_tiles) for the A loads a narrow tile
    repeats, 1.5 for a Hankel stride that conflicts); m_tiles is 2 where
    the accumulators and fragments fit the registers (n_tiles * parts <=
    12), the sum needs no flush and the layout fits, else 1.

    B streamed: where no block holds it, the depth runs in chunks, each
    with its slice of B and its A staged anew: the least group, the widest
    split, A as a window before copied rows, m_tiles 1, the first
    whose chunk is 256 deep (or the whole depth), else the deepest chunk;
    then the chunks are balanced over the depth.

    Flush: the tensor cores round a running float32 sum toward zero at
    each product, a bias that grows with the depth (one sum over 16,384
    taps erred by 2.4e-5 of scale on an H100); a band deeper than
    UF_FLUSH_DEPTH restarts its hi*hi sum every UF_FLUSH_STEPS steps, at
    m_tiles 1 (the kernel's instance with the total)."""
    parts = PARTS[algorithm]
    step = 8 // int(np.gcd(down, 8))
    geos, group = [], step
    while group == step or group * up <= 8 * MAX_N_TILES:
        geos.append((group,) + _upfirdn_geometry(up, down, taps_pp, offset,
                                                 group))
        group += step

    def layout(geo, n_tiles, col_blocks, k_chunk, hankel, k_pad=None):
        group, n_real, stride, k16, c_lo = geo
        k_pad = k_pad or k16
        flush = UF_FLUSH_STEPS if k_pad > UF_FLUSH_DEPTH else 0
        for m_tiles in (2, 1):
            if m_tiles == 2 and (n_tiles * parts > 12 or flush):
                continue
            pitch, win = _a_layout(stride, k_chunk, m_tiles, hankel)
            smem = upfirdn_smem_bytes(parts, n_tiles, k_chunk, win)
            if smem <= SMEM_BYTES:
                return UpfirdnPlan(
                    up, down, offset, taps_pp, group, n_real, n_tiles,
                    col_blocks, 8 * n_tiles * col_blocks, stride, k_pad,
                    k_chunk, m_tiles, flush, pitch, win, smem, c_lo)
        return None

    for hankel in (True, False):
        best = None
        for geo in geos:
            n_real, stride, k16 = geo[1:4]
            for n_tiles, col_blocks in _column_splits(-(-n_real // 8)):
                p = layout(geo, n_tiles, col_blocks, k16, hankel)
                if p is None:
                    continue
                cost = k16 * p.n_pad / n_real * (1 + 0.5 / n_tiles)
                if hankel and (stride // 8) % 2 == 0:
                    cost *= 1.5
                if best is None or cost < best[0]:
                    best = (cost, p)
        if best is not None:
            return best[1]

    geo = geos[0]
    stride, k16 = geo[2], geo[3]
    options = [(n_tiles, col_blocks, hankel, 1)
               for n_tiles, col_blocks in _column_splits(-(-geo[1] // 8))
               for hankel in (True, False)]
    depths = [_largest_k_chunk(parts, n_tiles, stride, m_tiles, hankel, k16)
              for n_tiles, _, hankel, m_tiles in options]
    pick = next((i for i, d in enumerate(depths) if d >= min(256, k16)),
                int(np.argmax(depths)))
    if depths[pick] == 0:
        return None
    n_tiles, col_blocks, hankel, _ = options[pick]
    chunks = -(-k16 // depths[pick])
    k_chunk = _round_up(-(-k16 // chunks), 16)
    return layout(geo, n_tiles, col_blocks, k_chunk, hankel,
                  k_pad=chunks * k_chunk)


def band_matrix_np(table: np.ndarray, p: UpfirdnPlan) -> np.ndarray:
    """(k_pad, n_pad) float64 B of the plan from the (up, taps_pp) table."""
    table = np.asarray(table, dtype=np.float64)
    n = np.arange(p.n_real)
    t = p.offset + n * p.down
    anchor, phase = t // p.up, t % p.up
    b = np.zeros((p.k_pad, p.n_pad))
    i = np.arange(p.taps_pp)
    rows = (anchor - p.c_lo)[None, :] - i[:, None]         # (taps_pp, n)
    b[rows, np.broadcast_to(n, rows.shape)] = table[phase[None, :],
                                                    i[:, None]]
    return b


def hankel_index(p: UpfirdnPlan, frames: int) -> np.ndarray:
    """(frames, k_pad) sample index of A: c_lo + f * stride + j."""
    return (p.c_lo + np.arange(frames)[:, None] * p.stride
            + np.arange(p.k_pad)[None, :])


def band_parts_np(table: np.ndarray, p: UpfirdnPlan,
                  algorithm: str) -> np.ndarray:
    """(parts, n_pad/8, k_pad/8, 8, 8) float32 bf16 values: B's parts in
    core-matrix layout."""
    b = band_matrix_np(table, p).astype(np.float32)
    return np.stack([core_layout_np(q)
                     for q in split_parts_np(b, PARTS[algorithm])])


_BAND_PARTS = PerTensor()


def band_parts(taps: torch.Tensor, p: UpfirdnPlan,
               algorithm: str) -> torch.Tensor:
    """band_parts_np as a bf16 tensor on taps' device, cached for the table
    tensor (rebuilt if it is written in place), so a call reads no table
    back from the device after its first."""
    def build():
        table = taps.detach().cpu().numpy().astype(np.float32)
        return torch.as_tensor(band_parts_np(table, p, algorithm),
                               device=taps.device).to(
                                   torch.bfloat16).contiguous()
    return _BAND_PARTS.get(taps, (p, algorithm), build)


# ---- windowed-DFT power -------------------------------------------------

def dft_cols(nfft: int) -> int:
    """Columns of the interleaved basis: 2 (nfft/2 + 1) rounded up to the
    kernel's DP_BN-column tile."""
    return _round_up(2 * (nfft // 2 + 1), DP_BN)


def interleave_np(bre: np.ndarray, bim: np.ndarray, cols: int) -> np.ndarray:
    """(nfft, bins) re and im -> (nfft, cols): column 2k re, 2k + 1 im,
    zero past column 2 bins."""
    nfft, bins = bre.shape
    b = np.zeros((nfft, cols), dtype=np.float64)
    b[:, 0:2 * bins:2] = bre
    b[:, 1:2 * bins:2] = bim
    return b


def dft_tiles_np(b: np.ndarray) -> np.ndarray:
    """(nfft, cols) -> (cols/DP_BN, nfft/DP_KC, DP_BN/8, DP_KC/8, 8, 8):
    the kernel's (K chunk, column tile) blocks, each contiguous in
    core-matrix layout."""
    nfft, cols = b.shape
    t = b.reshape(nfft // DP_KC, DP_KC // 8, 8, cols // DP_BN, DP_BN // 8, 8)
    return np.ascontiguousarray(t.transpose(3, 0, 4, 1, 5, 2))


def from_dft_tiles_np(t: np.ndarray) -> np.ndarray:
    """Inverse of dft_tiles_np."""
    n_t, k_c = t.shape[:2]
    return t.transpose(1, 3, 5, 0, 2, 4).reshape(k_c * DP_KC, n_t * DP_BN)


def dft_parts_np(bre: np.ndarray, bim: np.ndarray) -> np.ndarray:
    """(3, cols/DP_BN, nfft/DP_KC, DP_BN/8, DP_KC/8, 8, 8) float32: the f32
    tier's three bf16 parts of the interleaved basis, tiled."""
    b = interleave_np(bre, bim, dft_cols(bre.shape[0])).astype(np.float32)
    return np.stack([dft_tiles_np(q) for q in split_parts_np(b, 3)])


class DftPlan(NamedTuple):
    q: int            # nfft / hop
    tiles: int        # sample tiles serving one 32-sample depth stretch
    rows: int         # rows of a tile: DP_BM + ceil(q / tiles) - 1
    raw_bufs: int     # tiles of raw samples in flight
    smem: int         # dynamic shared memory of a block, bytes


def _dft_layout(q: int, tiles: int) -> DftPlan:
    """csrc/dft_power.cu's shared memory (DpLayout): two tiles of A's three
    parts and raw_bufs tiles of its samples, `rows` rows each, and DP_BBUFS
    chunks of B's three parts. Tile t of the q chunks serves a run of
    ceil(q / tiles) or floor(q / tiles) of them; raw_bufs = ceil(DP_AHEAD /
    floor(q / tiles)) tiles may be in flight at once."""
    rows = DP_BM + -(-q // tiles) - 1
    raw_bufs = -(-DP_AHEAD // (q // tiles))
    smem = (2 * (2 * 3 * rows * (DP_KC + 8) + DP_BBUFS * 3 * DP_KC * DP_BN)
            + 4 * raw_bufs * rows * DP_KC)
    return DftPlan(q, tiles, rows, raw_bufs, smem)


@functools.lru_cache(maxsize=64)
def dft_plan(nfft: int, hop: int) -> DftPlan:
    """The fewest sample tiles (the most reuse of a staged tile) whose
    layout fits a block; q tiles of one chunk each always fit."""
    q = nfft // hop
    tiles = 1
    while _dft_layout(q, tiles).smem > SMEM_BYTES:
        tiles += 1
    return _dft_layout(q, tiles)


def dft_chunk_tile(p: DftPlan, i: int) -> tuple[int, int, int]:
    """Chunk i of the kernel's depth order -> (o, r, tile, r0): stretch o
    of 32 samples of hop block r, read from sample tile `tile` (its first
    chunk r0), as csrc/dft_power.cu's chunk_tile computes it."""
    o, r = divmod(i, p.q)
    base, extra = divmod(p.q, p.tiles)
    if r < extra * (base + 1):
        t = r // (base + 1)
    else:
        t = extra + (r - extra * (base + 1)) // base
    return o, r, o * p.tiles + t, t * base + min(t, extra)


def dft_frame_index(nfft: int, hop: int, frames: int) -> np.ndarray:
    """(frames, nfft) sample index of A: f * hop + j."""
    return np.arange(frames)[:, None] * hop + np.arange(nfft)[None, :]
