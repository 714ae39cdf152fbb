"""Banded upfirdn: kernel 1 of the port, with its plain version and its
geometry (counterpart of ``vv_dsp_tpu/ops/pallas_upfirdn.py``).

    y[c, k] = sum_j x[c, j] * g[offset + k*down - j*up],  k in [0, n_out),

with x zero outside [0, n) (the ``_upfirdn_gather`` semantics). Both
versions take the filter as its polyphase table ``taps[p, i] = g[p + i*up]``
(``polyphase_table_np``), a float32 tensor on the signal's device.

``upfirdn_banded`` runs the tensor-core kernel (``csrc/upfirdn.cu``, its
plan in ``ops/mma_plan.py``) on a CUDA tensor and the plain version
``upfirdn_tall`` on a CPU tensor. The plain version is the tall-frames
matmul of ``vv_dsp_tpu/ops/resample.py::_upfirdn_tall``: frames of
``group*down`` input samples times one block-banded (width, group*up)
matrix, at the same dot-algorithm tier.

``_geometry``, ``pick_b_out`` and ``banded_supported`` are numpy copies of
the JAX kernel's segment rule (``vv_dsp_tpu/ops/pallas_upfirdn.py:40-75``).
They only route (``ops/filter_kernels.py`` sends a geometry to the banded
kernel where the JAX package does on the TPU); they are not this kernel's
shared-memory rule, which the C entry enforces itself.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vv_dsp_tpu_torch import _build, config
from vv_dsp_tpu_torch._build import ptr
from vv_dsp_tpu_torch.ops import mma_plan
from vv_dsp_tpu_torch.utils import profiling

_W_VMEM_CAP = 6 * 1024 * 1024   # the TPU kernel's resident weight budget
_EXT_ROWS_CAP = 4096            # its ext scratch rows (k_w) cap
_B_IN_CAP = 2048                # its DMA window rows cap
_EINVAL = 1                     # cudaErrorInvalidValue


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _geometry(up: int, down: int, len_g: int, offset: int, b_out: int):
    """(b_in, j_lo0, k_wp) for a segment of b_out outputs."""
    b_in = b_out * down // up
    j_lo0 = -(-(offset - len_g + 1) // up)
    j_hi = (offset + (b_out - 1) * down) // up
    k_wp = _round_up(j_hi - j_lo0 + 1, 8)
    return b_in, j_lo0, k_wp


def pick_b_out(up: int, down: int, len_g: int, offset: int) -> int | None:
    """Largest segment length whose weight matrix and scratch fit the TPU
    kernel's VMEM; None when no candidate fits."""
    for base in (2048, 1024, 512, 256, 128):
        b_out = _round_up(base, up)
        b_in, _, k_wp = _geometry(up, down, len_g, offset, b_out)
        if (b_out * k_wp * 4 <= _W_VMEM_CAP and k_wp <= _EXT_ROWS_CAP
                and b_in <= _B_IN_CAP and b_out <= 4096
                and -(-k_wp // b_in) - 1 <= 128):
            return b_out
    return None


def banded_supported(up: int, down: int, len_g: int, offset: int) -> bool:
    """Where the JAX package takes its banded kernel on the TPU."""
    return (up >= 1 and down >= 1 and up <= 512
            and pick_b_out(up, down, len_g, offset) is not None)


def polyphase_table_np(g, up: int) -> np.ndarray:
    """(up, taps_pp) float32 table taps[p, i] = g[p + i*up], zero-padded."""
    g = np.asarray(g, dtype=np.float64)
    taps_pp = -(-len(g) // up)
    g_pad = np.zeros(taps_pp * up, dtype=np.float64)
    g_pad[:len(g)] = g
    table = g_pad.reshape(taps_pp, up).T.astype(np.float32)
    return np.ascontiguousarray(table)


@functools.lru_cache(maxsize=16)
def _table_on(g_key: bytes, up: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(
        polyphase_table_np(np.frombuffer(g_key, dtype=np.float64), up),
        device=device)


def polyphase_table(g, up: int, device) -> torch.Tensor:
    """polyphase_table_np as a tensor on `device`, cached per filter."""
    g = np.ascontiguousarray(g, dtype=np.float64)
    return _table_on(g.tobytes(), up, torch.device(device))


def _tall_matrix(taps: torch.Tensor, up: int, down: int, offset: int,
                 group: int):
    """Block-banded (wd, group*up) matrix M[anchor_j - c_lo - i, j] =
    taps[phase_j, i] for frames of group*up outputs, and c_lo (see
    vv_dsp_tpu/ops/resample.py::_upfirdn_tall_plan). Built on taps' device."""
    taps_pp = taps.shape[1]
    dev = taps.device
    t = offset + np.arange(group * up) * down
    anchor, phase = t // up, t % up
    c_lo = int(anchor[0]) - (taps_pp - 1)
    wd = int(anchor[-1]) - c_lo + 1
    i = torch.arange(taps_pp, device=dev)[:, None]
    rows = torch.as_tensor(anchor - c_lo, device=dev)[None, :] - i
    cols = torch.arange(group * up, device=dev)[None, :].expand_as(rows)
    m = torch.zeros((wd, group * up), dtype=taps.dtype, device=dev)
    m[rows, cols] = taps[torch.as_tensor(phase, device=dev)[None, :], i]
    return m, c_lo


def default_group(taps_pp: int, down: int) -> int:
    """Frame stride ~ taps_pp (group*down ~ taps_pp), the JAX package's
    choice (vv_dsp_tpu/ops/resample.py::fir_resample_fused)."""
    return max(1, int(round(taps_pp / down)))


def upfirdn_tall(x: torch.Tensor, taps: torch.Tensor, up: int, down: int,
                 offset: int, n_out: int, algorithm: str | None = None,
                 group: int | None = None) -> torch.Tensor:
    """Plain version of the kernel: (..., n) -> (..., n_out) as one
    (frames, width) @ (width, group*up) matmul at the given tier."""
    algorithm = config.dot_algorithm(algorithm)
    if group is None:
        group = default_group(taps.shape[1], down)
    m, c_lo = _tall_matrix(taps, up, down, offset, group)
    wd, u = m.shape
    stride = group * down
    n_in = x.shape[-1]
    k_frames = -(-n_out // u)
    q = -(-wd // stride)
    width = q * stride
    m = torch.nn.functional.pad(m, (0, 0, 0, width - wd))
    pad_l = max(0, -c_lo)
    base = c_lo + pad_l
    pad_r = max(0, base + (k_frames + q - 1) * stride - (n_in + pad_l))
    xp = torch.nn.functional.pad(x, (pad_l, pad_r))
    frames = xp[..., base:base + (k_frames + q - 1) * stride].unfold(
        -1, width, stride)
    y = config.tier_matmul(frames, m.to(x.dtype), algorithm)
    return y.reshape(x.shape[:-1] + (k_frames * u,))[..., :n_out]


@_build.counted
def upfirdn_banded(x: torch.Tensor, taps: torch.Tensor, up: int, down: int,
                   offset: int, n_out: int,
                   algorithm: str | None = None) -> torch.Tensor:
    """(c, n) float32 -> (c, n_out) float32. A CPU tensor takes the plain
    version; a CUDA tensor launches the tensor-core kernel, or raises. The
    host plan (``ops/mma_plan.py``) gives the kernel its frame group, its
    tile layout (B resident, or streamed in depth chunks for long filters)
    and B's bf16 parts, cached per table; the kernel entry refuses a
    geometry it cannot run (up, down or taps_pp < 1, offset < 0). Rows
    beyond 65,535 take one launch a run of 65,535 (``_build.launch``).
    """
    algorithm = config.dot_algorithm(algorithm)
    if x.device.type == "cpu":
        return upfirdn_tall(x, taps, up, down, offset, n_out, algorithm)
    with profiling.span("kernel.upfirdn_banded"):
        _build.require_rows(x, "upfirdn_banded")
        taps_pp = taps.shape[-1]
        _build.require(taps, "taps", x.device, (up, taps_pp))
        c, n_in = x.shape
        y = torch.empty((c, n_out), dtype=torch.float32, device=x.device)
        if n_out == 0:
            return y
        if up < 1 or down < 1 or offset < 0 or taps_pp < 1:
            _build.check(_EINVAL, "upfirdn_banded")
        p = mma_plan.upfirdn_plan(up, down, taps_pp, offset, algorithm)
        bparts = mma_plan.band_parts(taps, p, algorithm)
        lib, dev, stream = _build.target(x)
        _build.launch(upfirdn_banded, c, lambda r0, k: lib.vv_upfirdn(
            ptr(x, r0), ptr(bparts), ptr(y, r0), k, n_in, n_out, up, down,
            offset, taps_pp, p.n_real, p.n_tiles, p.n_pad, p.stride, p.k_pad,
            p.k_chunk, p.m_tiles, p.a_pitch, p.win, p.flush, p.smem, p.c_lo,
            config.ALGORITHMS.index(algorithm), dev, stream))
        return y
