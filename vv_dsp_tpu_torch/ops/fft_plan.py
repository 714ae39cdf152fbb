"""Host side of the register-resident FFT of ``csrc/fft_reg.cuh``: its
radix plan and its per-pass twiddle table, and the shared-memory layouts of
the kernels built on it that vary with their arguments (the MFCC kernels',
packed and full-nfft, with their compact filterbank, the full-nfft
inverse's and fused gate's, and the packed inverse's and fused gate's,
whose strips grow with nfft/hop).

The N-point forward transform (N a power of two in [128, 2048]) runs as
Stockham passes over N/8 threads a frame, each thread holding 8 points in
registers. Pass p has radix R_p and stride Ns_p, the product of the radices
before it. Every pass is radix 8 except the first, which is radix 2 or 4
where log2 N is not a multiple of 3. Butterfly jv of pass p (jv < N/R_p)
reads points jv + r N/R_p, multiplies input r by
exp(-2 pi i r (jv mod Ns_p) / (R_p Ns_p)), takes the R_p-point DFT and
writes output r to (jv div Ns_p) Ns_p R_p + (jv mod Ns_p) + r Ns_p. The
last pass leaves the spectrum in natural order.

The first pass has Ns = 1 and needs no twiddles. Pass p >= 1 (radix 8)
reads its 7 Ns_p twiddles from the table at ``pass_offsets(n)[p]``, laid
out [r - 1][k] for r in 1..7 and k < Ns_p, so the lanes of a warp read
consecutive entries. The table is built in float64 and cast once to
float32; the kernel stages it in shared memory.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

MIN_N, MAX_N = 128, 2048
FR_POINTS = 2048             # complex points of a block's transforms
SMEM_BYTES = 232448          # shared memory one Hopper block may hold
# the MFCC kernel stages its tables while two blocks still fit an SM
# (228 KB, 1 KB of it reserved a block)
MFCC_SMEM_BUDGET = (233472 - 2 * 1024) // 2
WARPS = 256 // 32            # a block's warps: one peak slot each


def radix_plan(n: int) -> tuple[int, ...]:
    """The radices of the n-point transform's passes, first pass first."""
    if not (MIN_N <= n <= MAX_N and n & (n - 1) == 0):
        raise ValueError(f"the register-resident FFT takes a power of two "
                         f"in [{MIN_N}, {MAX_N}], got {n}")
    log2n = n.bit_length() - 1
    head = (1 << (log2n % 3),) if log2n % 3 else ()
    return head + (8,) * (log2n // 3)


def pass_strides(n: int) -> tuple[int, ...]:
    """Ns of each pass: the product of the radices before it."""
    strides, ns = [], 1
    for r in radix_plan(n):
        strides.append(ns)
        ns *= r
    return tuple(strides)


def pass_offsets(n: int) -> tuple[int, ...]:
    """Offset of each pass's twiddles in the table (the first pass has
    none), and the table's length as the last entry."""
    offs, at = [0], 0
    for r, ns in zip(radix_plan(n)[1:], pass_strides(n)[1:]):
        offs.append(at)
        at += (r - 1) * ns
    return tuple(offs) + (at,)


def pass_twiddles_np(n: int, dtype=np.float32) -> np.ndarray:
    """(table length, 2) (cos, sin) of the twiddles of passes 1.., built in
    float64 and cast to dtype."""
    parts = []
    for r, ns in zip(radix_plan(n)[1:], pass_strides(n)[1:]):
        rk = np.arange(1, r)[:, None] * np.arange(ns)[None, :]
        parts.append((-2.0 * np.pi * rk / (r * ns)).reshape(-1))
    a = np.concatenate(parts)
    return np.stack([np.cos(a), np.sin(a)], axis=-1).astype(dtype)


@functools.lru_cache(maxsize=16)
def pass_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """``pass_twiddles_np(n)`` as a float32 tensor on `device`."""
    return torch.as_tensor(pass_twiddles_np(n), device=device)


def table_size(n: int) -> int:
    """Length of the n-point transform's twiddle table."""
    return pass_offsets(n)[-1]


# ---- the packed MFCC kernel (csrc/stft.cu stft_mfcc_kernel) --------------

def compact_filterbank_np(mel_fb, bands) -> tuple[np.ndarray, np.ndarray]:
    """The MFCC kernel's filterbank: (weights, index). Band b's weights are
    mel_fb[b, lo_b:hi_b] over its band range ([lo; hi) rows of
    ``stft_kernels.band_edges_np``), concatenated band after band as float32;
    index = [off_0 .. off_n_mels, lo_0 .. lo_n_mels-1] int32, band b's
    weights at weights[off_b:off_b+1]. An all-zero band has an empty range
    and no weights."""
    fb = np.asarray(mel_fb, np.float32)
    lo, hi = (np.asarray(e, np.int64) for e in bands)
    off = np.concatenate([[0], np.cumsum(np.maximum(hi - lo, 0))])
    weights = np.zeros(off[-1], np.float32)
    for b in range(fb.shape[0]):
        weights[off[b]:off[b + 1]] = fb[b, lo[b]:hi[b]]
    return weights, np.concatenate([off, lo]).astype(np.int32)


def _mel_tables_smem(frames: int, n_mels: int, n_mfcc: int, nnz: int,
                     fuse_dct: bool, staged: bool) -> int:
    """Bytes of the MFCC kernels' tables: the log-mel rows of a group's
    frames (fuse_dct), the filterbank's index (2 n_mels + 1) and, staged,
    its nnz weights and the DCT rows."""
    rows = frames * n_mels if fuse_dct else 0
    tables = 2 * n_mels + 1 + (
        nnz + (n_mfcc * n_mels if fuse_dct else 0) if staged else 0)
    return 4 * (rows + tables)


def mfcc_smem(nfft: int, n_mels: int, n_mfcc: int, nnz: int,
              fuse_dct: bool, staged: bool) -> int:
    """Dynamic shared memory of an MFCC kernel block, bytes: the m-point
    twiddle table, wk (m + 1), two exchange buffers and the tables of
    ``_mel_tables_smem`` for its 2048/m frames."""
    m = nfft // 2
    return (8 * (table_size(m) + m + 1 + 2 * FR_POINTS)
            + _mel_tables_smem(FR_POINTS // m, n_mels, n_mfcc, nnz,
                               fuse_dct, staged))


def stockham_mel_smem(nfft: int, n_mels: int, n_mfcc: int, nnz: int,
                      fuse_dct: bool, staged: bool) -> int:
    """Dynamic shared memory of a full-nfft mel/MFCC block
    (``csrc/stockham.cu stockham_mel_kernel``), bytes: the nfft-point
    twiddle table, two exchange buffers and the tables of
    ``_mel_tables_smem`` for its 4096/nfft frames (no wk: the full
    transform needs no unpack twiddles)."""
    return (8 * (table_size(nfft) + 2 * FR_POINTS)
            + _mel_tables_smem(2 * FR_POINTS // nfft, n_mels, n_mfcc, nnz,
                               fuse_dct, staged))


class MfccPlan(NamedTuple):
    staged: bool      # the filterbank and DCT in shared memory
    smem: int         # dynamic shared memory of a block, bytes


def _mel_plan(smem_of, name: str, nfft: int, n_mels: int, n_mfcc: int,
              nnz: int, fuse_dct: bool) -> MfccPlan:
    smem = smem_of(nfft, n_mels, n_mfcc, nnz, fuse_dct, True)
    if smem <= MFCC_SMEM_BUDGET:
        return MfccPlan(True, smem)
    smem = smem_of(nfft, n_mels, n_mfcc, nnz, fuse_dct, False)
    if smem > SMEM_BYTES:
        raise ValueError(f"{name}: {n_mels} mel bands at nfft={nfft} "
                         f"need {smem} bytes of shared memory a block, "
                         f"above {SMEM_BYTES}")
    return MfccPlan(False, smem)


def mfcc_plan(nfft: int, n_mels: int, n_mfcc: int, nnz: int,
              fuse_dct: bool) -> MfccPlan:
    """The MFCC kernel's layout: the compact filterbank and the DCT rows
    staged in shared memory while a block stays within MFCC_SMEM_BUDGET,
    else read from device memory. Raises where even that does not fit a
    block (the log-mel rows of thousands of mel bands)."""
    return _mel_plan(mfcc_smem, "stft_mfcc", nfft, n_mels, n_mfcc, nnz,
                     fuse_dct)


def stockham_mel_plan(nfft: int, n_mels: int, n_mfcc: int, nnz: int,
                      fuse_dct: bool) -> MfccPlan:
    """``mfcc_plan`` for the full-nfft mel/MFCC kernel: its layout
    (``stockham_mel_smem``) has the nfft-point table and no wk."""
    return _mel_plan(stockham_mel_smem, "stft_mel_stockham", nfft, n_mels,
                     n_mfcc, nnz, fuse_dct)


# ---- the full-nfft inverse (csrc/stockham.cu istft_stockham_kernel) ------

def owned_segments(nfft: int, hop: int) -> int:
    """``csrc/common.cuh owned_segments``: the hop-long output segments a
    block of the overlap-add kernels owns, at least 4 (q - 1) against the
    q - 1 frames it recomputes (q = nfft/hop, rounded up), and a strip of
    at least 4096 samples."""
    q = -(-nfft // hop)
    return max(4 * (q - 1), -(-4096 // hop), 1)


def istft_smem(nfft: int, hop: int) -> int:
    """Dynamic shared memory of an inverse block, bytes: the twiddle
    table, two exchange buffers, the window and the strip."""
    return (8 * (table_size(nfft) + 2 * FR_POINTS)
            + 4 * (nfft + owned_segments(nfft, hop) * hop))


def gate_segments(nfft: int, hop: int) -> int:
    """``csrc/stockham.cu gate_segments``: the full-nfft gate's strip,
    ``owned_segments`` rounded up so that an item's seg + q - 1 frames fill
    whole groups of 4096/nfft frames (at 128/32 157 segments, 160 frames in
    5 groups of 32, where 128 would leave 29 of the 160 idle)."""
    fb, q1 = 2 * FR_POINTS // nfft, -(-nfft // hop) - 1
    return -(-(owned_segments(nfft, hop) + q1) // fb) * fb - q1


def stockham_gate_smem(nfft: int, hop: int) -> int:
    """Dynamic shared memory of a full-nfft fused gate block
    (``csrc/stockham.cu stockham_gate_kernel``), bytes: the twiddle table,
    two exchange buffers, a pair of peak slots (float2) a warp, the window
    and the strip of ``gate_segments`` hops. Largest at 2048/16, 89,952
    bytes."""
    return (8 * (table_size(nfft) + 2 * FR_POINTS + WARPS)
            + 4 * (nfft + gate_segments(nfft, hop) * hop))


# ---- the packed inverse and fused gate (csrc/istft.cu, csrc/gate_packed.cu)


def gate_packed_smem(nfft: int, hop: int) -> int:
    """Dynamic shared memory of a packed fused gate block, bytes
    (``csrc/packed.cuh packed_ola_smem``): the m = nfft/2 point twiddle
    table, wk (m + 1), two exchange buffers, the window, a peak slot a warp
    and the strip of ``owned_segments`` hops. The packed inverse's block
    has its spectrum stage in place of the table (``packed_istft_smem``).
    """
    m = nfft // 2
    return (8 * (table_size(m) + m + 1 + 2 * FR_POINTS)
            + 4 * (nfft + WARPS + owned_segments(nfft, hop) * hop))


def istft_stage_bytes(nfft: int) -> int:
    """The packed inverse's spectrum stage (``csrc/istft.cu istft_stage``):
    a group's 2048/m rows of m + 1 bins, the float2 that rounding the copy
    to 16 bytes may add at either end, rounded to 16 bytes (16,432 bytes
    at nfft 1024)."""
    m = nfft // 2
    return 8 * ((FR_POINTS // m * (m + 1) + 2) & ~1)


def packed_istft_smem(nfft: int, hop: int) -> int:
    """Dynamic shared memory of a packed inverse block, bytes
    (``csrc/istft.cu istft_smem``): the fused gate's layout
    (``gate_packed_smem``) with the spectrum stage (``istft_stage_bytes``)
    in place of the twiddle table, which the inverse reads from device
    memory. At nfft 4096 it is largest at hop 1 (16,380 owned samples),
    147,496 bytes: one block an SM; 73,816 at 1024/256, three."""
    return (istft_stage_bytes(nfft) - 8 * table_size(nfft // 2)
            + gate_packed_smem(nfft, hop))


def istft_groups(channels: int, nf: int, nfft: int, hop: int,
                 output_len: int) -> int:
    """Frame groups the packed inverse walks in one launch over `channels`
    rows (``csrc/istft.cu``; ``istft_kernels.ring_tally`` counts them):
    each strip item of ``owned_segments`` hops takes the frames that touch
    it, 2048/m at a time, m = nfft/2."""
    seg, q = owned_segments(nfft, hop), nfft // hop
    fb = FR_POINTS // (nfft // 2)
    per_row = -(-(-(-output_len // hop)) // seg)
    groups = 0
    for s in range(per_row):
        f_lo, f_hi = max(s * seg - (q - 1), 0), min(s * seg + seg - 1, nf - 1)
        groups += max(-(-(f_hi - f_lo + 1) // fb), 0)
    return channels * groups
