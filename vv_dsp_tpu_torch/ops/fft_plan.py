"""Host side of the register-resident FFT of ``csrc/fft_reg.cuh``: its
radix plan and its per-pass twiddle table.

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

import numpy as np
import torch

MIN_N, MAX_N = 128, 2048


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
