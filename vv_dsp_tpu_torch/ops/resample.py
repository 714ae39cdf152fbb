"""Resampling (counterpart of ``vv_dsp_tpu/ops/resample.py``): the
reference's linear and windowed-sinc resamplers, polyphase resampling and
the fused FIR + resample head.

The reference's resamplers (src/resample/resampler.c) give
floor((n-1) L/M) + 1 outputs; output k reads input position k M / L with
the edge samples held (``interpolate_linear``, ``interpolate_catmull_rom``);
``resample_sinc`` weighs ``taps`` inputs around floor(k M / L) by the
windowed sinc of its phase k mod L (``_sinc_phase_table``), a gather and a
per-phase dot.

Host constants (``_resample_poly_filter``, ``_fused_fir_resample_filter``,
``_staged_tail_matrix``, ``_upfirdn_conv_plan``, ``_factor_stages``) are
copies of the JAX package's numpy builders. The plain upfirdn forms compute
y[k] = sum_j x[j] h[offset + k*down - j*up] with the same numbers:

- ``_upfirdn_gather``: a gather of the (n_out, taps_pp) input windows and a
  per-phase dot (``upfirdn``, ``resample_poly``, scipy parity);
- ``_upfirdn_conv``: one strided ``conv1d`` with ``up`` output channels
  (``upfirdn_mxu``, ``resample_poly_mxu``), TF32 pinned off by ``config``;
- ``_upfirdn_frames_matmul``: the tall-frames matmul at ``group=1``
  (``ops/upfirdn.py::upfirdn_tall``), ``resample_poly_mxu``'s route at large
  ``up``.

``fir_resample_fused`` runs one banded upfirdn (ops/upfirdn.py) with the
composite filter (``upfirdn_tall`` where ``head_route`` finds the kernel
no layout), then recomputes the last outputs exactly as the staged pair
resample_poly(fir_apply(h, x)) defines them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import mma_plan
from vv_dsp_tpu_torch.ops.fir import fir_apply, fir_apply_mxu
from vv_dsp_tpu_torch.ops.upfirdn import (polyphase_table, upfirdn_banded,
                                          upfirdn_tall)
from vv_dsp_tpu_torch.ops.window import get_window_np
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp
from vv_dsp_tpu_torch.utils.shapes import collapse_leading


def _positions(pos, x: torch.Tensor) -> torch.Tensor:
    """Fractional positions as a tensor of x's dtype on x's device, held to
    [0, n-1]."""
    pos = torch.as_tensor(pos, dtype=x.dtype, device=x.device)
    return pos.clamp(0.0, float(x.shape[-1] - 1))


def interpolate_linear(x: torch.Tensor, pos) -> torch.Tensor:
    """Linear interpolation at fractional positions; pos <= 0 -> x[0],
    pos >= n-1 -> x[-1] (src/resample/interpolate.c:4-21)."""
    x = config.as_compute(x)
    n = x.shape[-1]
    pos = _positions(pos, x)
    i0 = torch.floor(pos).long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    frac = pos - i0
    return x[..., i0] * (1 - frac) + x[..., i1] * frac


def interpolate_catmull_rom(x: torch.Tensor, pos) -> torch.Tensor:
    """Catmull-Rom cubic with the neighbours held at the edges
    (src/resample/interpolate.c:23-64)."""
    x = config.as_compute(x)
    n = x.shape[-1]
    pos = _positions(pos, x)
    i1 = torch.floor(pos).long()
    t = pos - i1
    p0, p1, p2, p3 = (x[..., torch.clamp(i1 + d, 0, n - 1)]
                      for d in (-1, 0, 1, 2))
    t2 = t * t
    t3 = t2 * t
    return 0.5 * (2 * p1 + (-p0 + p2) * t
                  + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)


def output_length(n: int, l: int, m: int) -> int:
    """floor((n-1) * L/M) + 1 (src/resample/resampler.c:73)."""
    return (n - 1) * l // m + 1


def resample_linear(x: torch.Tensor, l: int, m: int) -> torch.Tensor:
    """Linear-interpolation rational resampler (the reference's linear
    path)."""
    x = config.as_compute(x)
    k = np.arange(output_length(x.shape[-1], l, m), dtype=np.float64)
    return interpolate_linear(x, k * m / l)


@functools.lru_cache(maxsize=64)
def _sinc_phase_table(l: int, m: int, taps: int) -> np.ndarray:
    """(L, taps) float64 windowed-sinc weights of the L fractional phases:
    output k has phase k mod L, whose fraction frac(k M / L) =
    (k M mod L) / L depends on it alone. Weights as
    src/resample/resampler.c:95-118: t = idx - in_pos, sinc(t cutoff) times
    a Hann window over the taps (N-1 denominator), cutoff = min(1, L/M),
    normalized by their sum."""
    cutoff = min(1.0, l / m)
    half = taps // 2
    win = get_window_np("hann", taps)
    rows = np.zeros((l, taps), dtype=np.float64)
    offs = np.arange(-half, taps - half, dtype=np.float64)
    for r in range(l):
        w = np.sinc((offs - (r * m % l) / l) * cutoff) * win
        s = w.sum()
        rows[r] = w / s if s != 0.0 else w
    return rows


def resample_sinc(x: torch.Tensor, l: int, m: int,
                  taps: int = 32) -> torch.Tensor:
    """Windowed-sinc rational resampler, the reference's semantics
    (src/resample/resampler.c:88-119): taps held to an even count in
    [4, 128], input indices held to [0, n-1]; a gather of each output's
    taps and a dot with its phase's weights."""
    x = config.as_compute(x)
    taps = int(np.clip(taps, 4, 128))
    taps += taps % 2
    n = x.shape[-1]
    k = np.arange(output_length(n, l, m))
    half = taps // 2
    idx = np.clip((k * m // l)[:, None]
                  + np.arange(-half, taps - half)[None, :], 0, n - 1)
    w = torch.as_tensor(_sinc_phase_table(l, m, taps)[k % l], dtype=x.dtype,
                        device=x.device)
    gathered = x[..., torch.as_tensor(idx, device=x.device)]
    return torch.einsum("...ot,ot->...o", gathered, w)


@functools.lru_cache(maxsize=64)
def _resample_poly_filter(up: int, down: int) -> np.ndarray:
    """scipy.signal.resample_poly default anti-alias FIR: firwin with a
    Kaiser(5.0) window, 2*10*max(up,down)+1 taps, cutoff 1/max(up,down),
    scaled by up."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    numtaps = 2 * half_len + 1
    n = np.arange(numtaps, dtype=np.float64) - half_len
    h = f_c * np.sinc(f_c * n)
    h *= get_window_np("kaiser", numtaps, 5.0)
    h /= h.sum()  # firwin scales so DC gain is 1
    return h * up


def _reduce(up: int, down: int) -> tuple[int, int]:
    g = math.gcd(up, down)
    return up // g, down // g


def _upfirdn_gather(h, x: torch.Tensor, up: int, down: int, offset: int,
                    n_out: int) -> torch.Tensor:
    """Polyphase upfirdn core: y[k] = full[offset + k*down] where
    full[t] = sum_j x[j] h[t - j*up]. For t = offset + k*down the inputs
    are j = t//up - i with tap h[(t mod up) + i*up]: a gather of the
    (n_out, taps_pp) windows, then a per-phase dot."""
    h = np.asarray(h, dtype=np.float64)
    n_in = x.shape[-1]
    taps_pp = -(-len(h) // up)
    h_pad = np.zeros(taps_pp * up, dtype=np.float64)
    h_pad[:len(h)] = h
    hpp = h_pad.reshape(taps_pp, up).T  # hpp[p, i] = h[p + i*up]
    t = offset + np.arange(n_out) * down
    idx = (t // up)[:, None] - np.arange(taps_pp)[None, :]
    valid = (idx >= 0) & (idx < n_in)
    dev = x.device
    gathered = x[..., torch.as_tensor(np.clip(idx, 0, max(n_in - 1, 0)),
                                      device=dev)]  # (..., n_out, taps_pp)
    gathered = torch.where(torch.as_tensor(valid, device=dev), gathered,
                           torch.zeros((), dtype=x.dtype, device=dev))
    w = torch.as_tensor(hpp[t % up], dtype=x.dtype, device=dev)
    return torch.einsum("...ot,ot->...o", gathered, w)


def upfirdn(h, x: torch.Tensor, up: int = 1, down: int = 1) -> torch.Tensor:
    """scipy.signal.upfirdn parity: zero-stuff by up, filter with h,
    downsample by down; output length ceil(((n_in-1)*up + len(h)) / down)."""
    x = config.as_compute(x)
    n_out = -(-((x.shape[-1] - 1) * up + len(np.asarray(h))) // down)
    return _upfirdn_gather(h, x, up, down, 0, n_out)


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """scipy.signal.resample_poly(x, up, down) parity: output length
    ceil(n*up/down), the centred (zero-delay) default Kaiser filter."""
    x = config.as_compute(x)
    up, down = _reduce(up, down)
    if up == 1 and down == 1:
        return x
    n_out = -(-x.shape[-1] * up // down)
    h = _resample_poly_filter(up, down)
    return _upfirdn_gather(h, x, up, down, (len(h) - 1) // 2, n_out)


@functools.lru_cache(maxsize=64)
def _upfirdn_conv_plan(h_key, up: int, down: int, offset: int):
    """Geometry of the strided-conv upfirdn. Outputs come in frames of `up`:
    y[k*up + p] reads x[k*down + a_p - i] with a_p = (offset + p*down)//up
    and weight h[r_p + i*up], r_p = (offset + p*down) % up, so the whole
    resample is ONE cross-correlation with stride `down` and `up` output
    channels, W[p, c] = h[r_p + (a_p - c_lo - c)*up]. Returns (W (up, Wd)
    float64, c_lo)."""
    h = np.asarray(h_key, dtype=np.float64)
    h_pad = np.zeros((-(-len(h) // up)) * up, dtype=np.float64)
    h_pad[: len(h)] = h
    taps_pp = len(h_pad) // up
    t = offset + np.arange(up) * down
    anchor = t // up
    phase = t % up
    c_lo = int(anchor[0]) - (taps_pp - 1)
    wd = int(anchor[-1]) - c_lo + 1
    w = np.zeros((up, wd), dtype=np.float64)
    i = np.arange(taps_pp)
    for pp in range(up):
        w[pp, anchor[pp] - c_lo - i] = h_pad[phase[pp] + i * up]
    return w, c_lo


def _upfirdn_conv(h, x: torch.Tensor, up: int, down: int, offset: int,
                  n_out: int) -> torch.Tensor:
    """upfirdn as one strided conv1d (see _upfirdn_conv_plan); the
    (batch, up, frames) result reads out in natural order after one
    transpose."""
    w, c_lo = _upfirdn_conv_plan(tuple(np.asarray(h, np.float64)), up, down,
                                 offset)
    wd = w.shape[1]
    n_in = x.shape[-1]
    k_frames = -(-n_out // up)
    pad_l = max(0, -c_lo)
    last_needed = (k_frames - 1) * down + c_lo + wd - 1
    pad_r = max(0, last_needed - (n_in - 1))
    xb = x.reshape(-1, 1, n_in)
    start = c_lo + pad_l   # a positive c_lo skips the first samples
    xb = F.pad(xb, (pad_l, pad_r))[..., start:]
    wt = torch.as_tensor(w, dtype=x.dtype, device=x.device)[:, None, :]
    y = F.conv1d(xb, wt, stride=down)[..., :k_frames]   # (batch, up, K)
    y = y.transpose(-1, -2).reshape(x.shape[:-1] + (k_frames * up,))
    return y[..., :n_out]


def _upfirdn_frames_matmul(h, x: torch.Tensor, up: int, down: int,
                           offset: int, n_out: int) -> torch.Tensor:
    """upfirdn as strided frames times one (Win, up) matrix: the group=1
    instance of the tall-frames plan (ops/upfirdn.py::upfirdn_tall)."""
    taps = polyphase_table(h, up, x.device)
    return upfirdn_tall(x, taps, up, down, offset, n_out, "f32", group=1)


def resample_poly_mxu(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """scipy.signal.resample_poly parity on the matmul forms (the JAX
    package's route): large `up` with a short frame overlap
    (q = ceil((down + taps_pp)/down) <= 4) takes the frames matmul, the
    rest the strided conv."""
    x = config.as_compute(x)
    up, down = _reduce(up, down)
    if up == 1 and down == 1:
        return x
    n_out = -(-x.shape[-1] * up // down)
    h = _resample_poly_filter(up, down)
    half_len = (len(h) - 1) // 2
    taps_pp = -(-len(h) // up)
    q = -(-(down + taps_pp) // down)
    if up >= 32 and q <= 4:
        return _upfirdn_frames_matmul(h, x, up, down, half_len, n_out)
    return _upfirdn_conv(h, x, up, down, half_len, n_out)


def upfirdn_mxu(h, x: torch.Tensor, up: int = 1,
                down: int = 1) -> torch.Tensor:
    """scipy.signal.upfirdn parity on the strided-conv path."""
    x = config.as_compute(x)
    n_out = -(-((x.shape[-1] - 1) * up + len(np.asarray(h))) // down)
    return _upfirdn_conv(h, x, up, down, 0, n_out)


@functools.lru_cache(maxsize=16)
def _fused_fir_resample_filter(fir_key, up: int, down: int):
    """Composite filter g = conv(zero-stuff_up(h_fir), h_resample): filtering
    at the input rate then polyphase-resampling equals ONE upfirdn with g
    (out[t] = sum_i x[i] g[t - up*i]). Returns (g float64, offset)."""
    h_f = np.asarray(fir_key, dtype=np.float64)
    h_r = _resample_poly_filter(up, down)
    up_f = np.zeros((len(h_f) - 1) * up + 1, dtype=np.float64)
    up_f[::up] = h_f
    return np.convolve(up_f, h_r), (len(h_r) - 1) // 2


@functools.lru_cache(maxsize=16)
def _staged_tail_matrix(h_key, up: int, down: int, offset: int, n_in: int,
                        m0: int, n_tail: int):
    """(W (n_tail, width) float64, jw0): the staged fused-head tail as one
    dense matrix over the input window x[jw0:n_in] — staged means the FIR
    intermediate is truncated at n_in (k < n_in), which is the one place the
    pure composite filter differs from resample_poly(fir_apply(x))."""
    h_fir = np.asarray(h_key, dtype=np.float64)
    h_r = _resample_poly_filter(up, down)
    len_r = len(h_r)
    taps_f = len(h_fir)
    # y_st[m] = sum_k 1[0<=k<n_in] h_r[offset + m*down - k*up] * y_fir[k],
    # y_fir[k] = sum_u h_fir[u] x[k-u]
    ms = np.arange(m0, m0 + n_tail)
    k_hi = min(n_in - 1, (offset + int(ms[-1]) * down) // up)
    k_lo = max(0, -(-(offset + int(ms[0]) * down - len_r + 1) // up))
    jw0 = k_lo - taps_f + 1
    width = k_hi - jw0 + 1
    # A[m, k] = h_r coefficient; B[k, j] = h_fir[k - j]
    kk = np.arange(k_lo, k_hi + 1)
    gi = offset + ms[:, None] * down - kk[None, :] * up
    a = np.where((gi >= 0) & (gi < len_r), h_r[np.clip(gi, 0, len_r - 1)], 0.0)
    jj = np.arange(jw0, jw0 + width)
    fi = kk[:, None] - jj[None, :]
    b = np.where((fi >= 0) & (fi < taps_f),
                 h_fir[np.clip(fi, 0, taps_f - 1)], 0.0)
    w = a @ b  # (n_tail, width)
    if jw0 < 0:  # clip columns for x indices < 0 (zero samples)
        w = w[:, -jw0:]
        jw0 = 0
    return np.ascontiguousarray(w), jw0


@functools.lru_cache(maxsize=16)
def _tail_weights(fir_key: bytes, up: int, down: int, offset: int, n_in: int,
                  m0: int, n_tail: int, device: torch.device):
    """(W^T (width, n_tail) float32 on `device`, jw0) of
    _staged_tail_matrix."""
    h = np.frombuffer(fir_key, dtype=np.float64)
    w, jw0 = _staged_tail_matrix(tuple(h), up, down, offset, n_in, m0, n_tail)
    wt = np.ascontiguousarray(w.T, dtype=np.float32)
    return torch.as_tensor(wt, device=device), jw0


def head_route(up: int, down: int, taps_pp: int, offset: int,
               algorithm: str | None) -> str:
    """The fused head's route: "banded" (kernel 1 on a CUDA tensor, its
    plain version on the CPU) wherever ``mma_plan.upfirdn_fits`` finds the
    kernel a layout, which covers ``banded_supported``'s geometries and
    beyond; else "torch", ``upfirdn_tall`` in the JAX package's frame
    group."""
    if mma_plan.upfirdn_fits(up, down, taps_pp, offset,
                             config.dot_algorithm(algorithm)):
        return "banded"
    return "torch"


def fir_resample_fused(h_fir, x: torch.Tensor, up: int, down: int,
                       group: int | None = None,
                       algorithm: str | None = None, *,
                       taps: torch.Tensor | None = None) -> torch.Tensor:
    """resample_poly(fir_apply(h_fir, x), up, down) as one banded upfirdn:
    (..., n) -> (..., ceil(n*up/down)) float32, sample-exact against the
    staged pair including the staged FIR's end-of-signal truncation.

    group: the "torch" route's frame group (``upfirdn_tall``; None: the
    JAX package's ``default_group``); it picks the frame width and changes
    no output value. The kernel route keeps its own tiling.
    algorithm: the banded contraction's tier ("f32" | "bf16x3" | "bf16").
    taps: the composite filter's polyphase table on x's device (a module
    passes its buffer); built from h_fir when None."""
    if group is not None and (isinstance(group, bool) or not isinstance(
            group, (int, np.integer)) or group < 1):
        raise ValueError(f"group must be None or a positive int, got "
                         f"{group!r}")
    x = config.as_compute(x)
    if x.ndim != 2:
        x2, restore = collapse_leading(x)
        return restore(fir_resample_fused(h_fir, x2, up, down, group=group,
                                          algorithm=algorithm, taps=taps), 1)
    x = x.float().contiguous()   # the kernel takes contiguous rows
    up, down = _reduce(up, down)
    h_np = np.ascontiguousarray(h_fir, dtype=np.float64)
    if up == 1 and down == 1:
        return fir_apply_mxu(h_np, x)
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    gf, offset = _fused_fir_resample_filter(tuple(h_np), up, down)
    m0 = max(0, -(-(up * n_in - offset) // down))
    n_tail = n_out - m0
    staged_tail = 0 < n_tail <= 1024 and m0 > 0
    if taps is None:
        taps = polyphase_table(gf, up, x.device)
    taps_pp = taps.shape[1]
    if head_route(up, down, taps_pp, offset, algorithm) == "banded":
        y = kernel_with_torch_vjp(
            lambda xv: upfirdn_banded(xv, taps, up, down, offset, n_out,
                                      algorithm),
            lambda xv: upfirdn_tall(xv, taps, up, down, offset, n_out, "f32"),
        )(x)
    else:
        # the JAX package's XLA route: the tall-frames matmul in its frame
        # group (``upfirdn.default_group``), at the knob's tier
        y = upfirdn_tall(x, taps, up, down, offset, n_out, None, group)
    if staged_tail:
        # the staged definition for the few outputs whose window crosses the
        # FIR's end collapses to a small dense matmul over the input's tail
        wt, jw0 = _tail_weights(h_np.tobytes(), up, down, offset, n_in, m0,
                                n_tail, x.device)
        tail = x[..., jw0:] @ wt[:x.shape[-1] - jw0]
        y = torch.cat([y[..., :m0], tail], dim=-1)
    elif m0 < n_out:
        # a signal shorter than the resample filter's half-length, or a
        # tail past 1024 outputs: the staged pair over the input's end
        h_r = _resample_poly_filter(up, down)
        taps_r = -(-len(h_r) // up)
        jlo = (offset + m0 * down) // up - taps_r + 1
        s0 = max(0, jlo - len(h_np) + 1)
        y_t = fir_apply(h_np, x[..., s0:])
        tail = _upfirdn_gather(h_r, y_t, up, down,
                               offset + m0 * down - up * s0, n_out - m0)
        y = torch.cat([y[..., :m0], tail], dim=-1)
    return y


def _factor_stages(up: int, down: int, max_side: int = 9):
    """Split L/M into a cascade of small rational stages (each side's factor
    <= max_side). Greedy: pair the largest remaining up-factor with the
    largest remaining down-factor per stage."""
    def prime_factors(v):
        out = []
        d = 2
        while d * d <= v:
            while v % d == 0:
                out.append(d)
                v //= d
            d += 1
        if v > 1:
            out.append(v)
        return out

    def group(factors):
        # multiply small primes together while staying <= max_side; a prime
        # above max_side becomes its own stage
        groups = []
        for f in sorted(factors, reverse=True):
            if f > max_side:
                groups.append(f)
                continue
            for i, g in enumerate(groups):
                if g * f <= max_side:
                    groups[i] = g * f
                    break
            else:
                groups.append(f)
        return sorted(groups, reverse=True)

    ups = group(prime_factors(up)) if up > 1 else []
    downs = group(prime_factors(down)) if down > 1 else []
    stages = []
    while ups or downs:
        stages.append((ups.pop(0) if ups else 1, downs.pop(0) if downs else 1))
    return stages


def resample_multistage(x: torch.Tensor, up: int, down: int,
                        use_pallas: bool | None = None) -> torch.Tensor:
    """Rational resampling as a cascade of small polyphase stages. A
    cascade of Kaiser anti-aliasers, not sample-exact against scipy's
    single filter; output length ceil(n*L/M).

    use_pallas: True or None runs each stage through
    ``filter_kernels.resample_poly_best`` (the JAX package's TPU route, on
    every device); False through ``resample_poly``, as the JAX function
    does off the TPU. The option is there only so that the JAX function's
    calls run unchanged: no path in the port sets it False."""
    # imported here: filter_kernels imports this module
    from vv_dsp_tpu_torch.ops.filter_kernels import resample_poly_best
    x = config.as_compute(x)
    up, down = _reduce(up, down)
    if up == 1 and down == 1:
        return x
    n_out_target = -(-x.shape[-1] * up // down)
    stage = (resample_poly_best if use_pallas is None or use_pallas
             else resample_poly)
    for u, d in _factor_stages(up, down):
        x = stage(x, u, d)
    # a cascade of ceils can overshoot by a sample or two
    return x[..., :n_out_target]
