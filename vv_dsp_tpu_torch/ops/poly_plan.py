"""Host plan of the per-phase polyphase kernel (``csrc/filter.cu
poly_kernel``): its instance, its block, its shared-memory layout and its
tap tables, for one reduced (up, down).

The kernel computes

    y[c, m] = sum_{i < T} hpp[t mod up, i] x[c, t div up - i],
    t = half_len + m down,  x = 0 outside [0, n_in),

T = taps_pp, hpp the (up, T) polyphase table of scipy.signal.resample_poly's
filter. Output m = q up + s is frame q, phase s, and phase s of frame q
reads x[q down + a_s - i] with tap row p_s (a_s, p_s = divmod(half_len +
s down, up)). Residue classes: writing a_s - i = M down + r (0 <= r <
down), the taps of phase s fall into min(down, T) classes by r, class r
holding taps i = i_r + k down (i_r = (a_s - r) mod down, k < n_r =
ceil((T - i_r) / down)), so

    y[q up + s] = sum_r sum_{k < n_r} w[s, r, k] X_r[q + M_sr - k],
    X_r[j] = x[j down + r],

a unit-stride correlation of n_r taps along residue row r. A class holds
K = ceil(T / down) taps or K - 1, and every phase has the same n_big
classes of K (T - (K - 1) down of them; all its min(down, T) classes at K
= 1); the kernel runs those first, then the rest, one instance each of K
and K - 1 taps. Over the 377 reduced geometries ``resample_poly_kernel``
sends to the kernel (up * T <= 512) K takes only the values of
``K_INSTANCES``.

A tile is ``frames`` consecutive frames of one row, from q0, in groups of
GROUP = 32 * POLY_R; its work items are (phase s, group g), item i = g up
+ s, and warp w of the block takes items w, w + warps, ...: lane l owns
frames g GROUP + l POLY_R .. + POLY_R - 1 of the tile for phase s. With
up >= 2 a tile is one group and each warp takes ceil(up / 8) phases or
fewer (up warps up to 8); with up = 1 a tile is 4 groups of 4 warps, or
fewer where their windows would not fit SMEM_TARGET. A persistent grid of
blocks walks the tiles (block b takes tiles b, b + grid, ..., tile i of a
row's ``ceil(ceil(n_out / up) / frames)`` being that row's frames from q0
= i * frames), copying the next tile's window in while it computes the
current one. Shared memory, in order (``PolyPlan``):

- ws: the classes' taps, class s * ncls + ci at ws[(s * ncls + ci) * kp],
  kp = K rounded up to 4 (16-byte rows, read as broadcast float4);
- os: each class's window start, r * q_pitch + M_sr - (K - 1) - lo;
- xs0, xs1: two window buffers (a block's tiles alternate between them),
  each with residue row r at r * q_pitch, column j holding
  X_r[q0 + lo + j], j < row_len = frames + hi - lo (lo the least
  M_sr - (K - 1), hi the largest M_sr);
- ys: phase row s at ys[s * p_pitch], column f the output of frame q0 + f.

Bank conflicts. Thread t reads its window at column t * POLY_R + os and
writes its outputs at t * POLY_R + s * p_pitch: lanes POLY_R (odd) words
apart, no conflict. The window is copied in by whole columns: lane l <
g_in * down (g_in = 32 // down) copies row l mod down, column
c0 + l div down; q_pitch = g_in (mod 32) puts the copies of a warp on
distinct banks. The outputs go out the same way, lane l < g_out * up
(g_out = 32 // up) storing phase l mod up of frame f0 + l div up, one run
of g_out * up outputs a warp, p_pitch = g_out (mod 32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from vv_dsp_tpu_torch.ops.resample import _reduce, _resample_poly_filter

POLY_R = 11                  # csrc/filter.cu's frames a thread
GROUP = 32 * POLY_R          # frames a warp's item
K_INSTANCES = (1, 2, 3, 4, 5, 6, 7, 11, 21)   # csrc/filter.cu's instances
MAX_WARPS = 8                # csrc/filter.cu's POLY_MAX_THREADS / 32
SMEM_TARGET = 48 * 1024      # an up = 1 block's shared memory
SMEM_BYTES = 232448          # shared memory one Hopper block may hold
POLY_MAX_WEIGHTS = 512       # resample_poly_pallas's up * taps_pp limit


class PolyPlan(NamedTuple):
    up: int
    down: int
    half_len: int
    taps_pp: int
    k: int              # the instance: taps of a phase's first classes
    ncls: int           # classes a phase
    n_big: int          # classes of k taps a phase; the rest have k - 1
    threads: int
    frames: int         # frames a block
    lo: int             # X_r column of xs column 0, relative to q0
    row_len: int        # columns of a residue row
    q_pitch: int        # words between residue rows
    p_pitch: int        # words between phase rows
    smem: int           # dynamic shared memory, bytes
    weights: np.ndarray  # (up * ncls * kp,) float64; ws holds it in float32
    offsets: np.ndarray  # (up * ncls,) int32, os

    @property
    def kp(self) -> int:
        return -(-self.k // 4) * 4


def phase_classes(up: int, down: int, half_len: int, taps_pp: int):
    """For each phase s, its tap row p_s and its classes as (r, i_r, M_sr,
    n_r), those of the most taps first, then in ascending r: taps i_r + k
    down (k < n_r = ceil((taps_pp - i_r) / down)) read X_r[q + M_sr - k]."""
    out = []
    for s in range(up):
        a, p = divmod(half_len + s * down, up)
        cls = []
        for r in range(down):
            i_r = (a - r) % down
            if i_r < taps_pp:
                cls.append((r, i_r, (a - r - i_r) // down,
                            -(-(taps_pp - i_r) // down)))
        out.append((p, sorted(cls, key=lambda c: (-c[3], c[0]))))
    return out


def smem_bytes(up: int, down: int, ncls: int, kp: int, q_pitch: int,
               p_pitch: int) -> int:
    """csrc/filter.cu vv_poly's dynamic shared memory: ws, os, two windows,
    ys."""
    return 4 * (up * ncls * (kp + 1) + 2 * down * q_pitch + up * p_pitch)


def _pitch(n: int, residue: int) -> int:
    """The least pitch >= n congruent to residue mod 32."""
    return n + (residue - n) % 32


@functools.lru_cache(maxsize=512)
def poly_plan(up: int, down: int) -> PolyPlan:
    """The plan of reduced (up, down); raises where the kernel takes no
    such geometry (up * taps_pp above 512, a class longer than the largest
    instance, or no block size that fits a block's shared memory)."""
    if _reduce(up, down) != (up, down) or up < 1 or down < 1:
        raise ValueError(f"poly_plan takes a reduced ratio, got {up}/{down}")
    h = _resample_poly_filter(up, down)
    half_len = (len(h) - 1) // 2
    taps_pp = -(-len(h) // up)
    if up * taps_pp > POLY_MAX_WEIGHTS or up > 32 or down > 32:
        raise ValueError(f"{up}/{down}: {up * taps_pp} weights, outside the "
                         f"per-phase kernel's range")
    k = -(-taps_pp // down)
    if k not in K_INSTANCES:
        raise ValueError(f"{up}/{down}: classes of {k} taps, not an "
                         f"instance of the kernel ({K_INSTANCES})")
    kp = -(-k // 4) * 4
    h_pad = np.zeros(up * taps_pp)
    h_pad[:len(h)] = h
    hpp = h_pad.reshape(taps_pp, up).T          # hpp[p, i] = h[p + i*up]
    classes = phase_classes(up, down, half_len, taps_pp)
    ncls = len(classes[0][1])
    n_big = sum(n == k for *_, n in classes[0][1])
    lo = min(m - (n - 1) for _, cls in classes for _, _, m, n in cls)
    hi = max(m for _, cls in classes for _, _, m, _ in cls)
    weights = np.zeros((up, ncls, kp))
    for s, (p, cls) in enumerate(classes):
        assert [n for *_, n in cls] == [k] * n_big + [k - 1] * (ncls - n_big)
        for ci, (_, i_r, _, n) in enumerate(cls):
            weights[s, ci, :n] = hpp[p, i_r::down]
    if up >= 2:
        per_warp = -(-up // MAX_WARPS)
        shapes = [(-(-up // per_warp), 1)]     # (warps, groups)
    else:
        shapes = [(4, 4), (2, 2), (1, 1)]
    for warps, groups in shapes:
        threads, frames = 32 * warps, GROUP * groups
        row_len = frames + hi - lo
        q_pitch = _pitch(row_len, 32 // down)
        p_pitch = _pitch(frames, 32 // up)
        smem = smem_bytes(up, down, ncls, kp, q_pitch, p_pitch)
        if smem <= SMEM_TARGET:
            break
    if smem > SMEM_BYTES:
        raise ValueError(f"{up}/{down}: {smem} bytes of shared memory a "
                         f"block, above {SMEM_BYTES}")
    offsets = np.array([r * q_pitch + m - (n - 1) - lo
                        for _, cls in classes for r, _, m, n in cls], np.int32)
    return PolyPlan(up, down, half_len, taps_pp, k, ncls, n_big, threads,
                    frames, lo, row_len, q_pitch, p_pitch, smem,
                    weights.reshape(-1), offsets)


@functools.lru_cache(maxsize=64)
def poly_tables(up: int, down: int, device: torch.device):
    """(weights, offsets) of ``poly_plan(up, down)`` on `device`, built
    once per geometry."""
    p = poly_plan(up, down)
    return (torch.as_tensor(p.weights.astype(np.float32), device=device),
            torch.as_tensor(p.offsets, device=device))


def kernel_geometries() -> list[tuple[int, int]]:
    """Every reduced (up, down), up != down, that ``resample_poly_kernel``
    sends to the kernel: up * taps_pp <= 512 (up <= 24; down <= 25)."""
    out = []
    for up in range(1, 33):
        for down in range(1, 33):
            if up == down or _reduce(up, down) != (up, down):
                continue
            taps = len(_resample_poly_filter(up, down))
            if up * -(-taps // up) <= POLY_MAX_WEIGHTS:
                out.append((up, down))
    return out
