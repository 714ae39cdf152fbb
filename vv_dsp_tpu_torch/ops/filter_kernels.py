"""The direct FIR and per-phase polyphase kernels, with their plain
versions, and the best-path dispatch of FIR and resampling (counterpart of
``vv_dsp_tpu/ops/pallas_kernels.py``: ``fir_apply_pallas``,
``resample_poly_pallas``, ``fir_apply_best``, ``resample_poly_best``).

- ``fir_direct`` runs ``csrc/filter.cu::fir_direct_kernel`` on a CUDA
  tensor and its plain version ``fir_direct_plain`` (``fir.fir_apply``) on
  a CPU tensor.
- ``resample_poly_kernel`` runs ``csrc/filter.cu::poly_kernel`` on a CUDA
  tensor, in the layout of its host plan ``ops/poly_plan.py``, and
  ``resample_poly_plain`` (``resample.resample_poly``) on a CPU tensor.
- ``fir_os`` runs ``csrc/fir_os.cu::fir_os_kernel`` (overlap-save on the
  register-resident FFT, one fused kernel; the JAX package's
  ``fir.fir_apply_os`` is XLA rffts, so it ports no TPU kernel) on a CUDA
  tensor and its plain version ``fir_os_plain`` (the same segments and
  table through ``torch.fft``) on a CPU tensor.

On a CUDA tensor each wrapper launches its kernel (once per 65,535 rows,
``_build.launch``) or raises. The best
paths route as the JAX package routes on the TPU, on every device, but
for fir_apply_best's overlap-save route, which this card takes in place of
the banded kernel's f32 tier:

- ``fir_apply_best``: up to 16 taps the direct kernel; at the f32 tier,
  from ``OS_MIN_TAPS`` to 2,048 taps that need no grad, ``fir_os``; else
  from 512 taps that need no grad, where ``banded_supported(1, 1, taps,
  0)``, the banded upfirdn at up = down = 1 (the bf16x3 and bf16 tiers,
  as the JAX package routes every tier); anything else (taps that require
  grad included) ``fir.fir_apply_mxu``. Tensor taps are read back to the
  host once per tensor (``_host_taps``) for either kernel's table. The
  calls of each route are tallied in ``fir_apply_best.route_calls``.
- ``resample_poly_best``: up < 32 (after the gcd) where
  ``banded_supported`` the banded upfirdn at offset half_len; anything else
  ``resample.resample_poly_mxu``.

Each kernel route differentiates its plain form (``kernel_with_torch_vjp``).
With no tier named, the banded routes run ``config.dot_algorithm(None)``,
"f32", as the JAX package's do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from vv_dsp_tpu_torch import _build, config
from vv_dsp_tpu_torch._build import ptr
from vv_dsp_tpu_torch.ops import fft_plan, poly_plan
from vv_dsp_tpu_torch.ops.fir import fir_apply, fir_apply_mxu, taps_like
from vv_dsp_tpu_torch.ops.resample import (_reduce, _resample_poly_filter,
                                           resample_poly, resample_poly_mxu)
from vv_dsp_tpu_torch.ops.upfirdn import (banded_supported, polyphase_table,
                                          upfirdn_banded)
from vv_dsp_tpu_torch.utils import profiling
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp
from vv_dsp_tpu_torch.utils.shapes import collapse_leading
from vv_dsp_tpu_torch.utils.tensor_cache import PerTensor

DIRECT_MAX_TAPS = 16      # fir_apply_best's direct-kernel route
BANDED_MIN_TAPS = 512     # ... its banded route
OS_MIN_TAPS = 512         # ... and its overlap-save route (the f32 tier)
OS_NFFT = 4096            # fir_os's segment: the 4,096-point real FFT
# fir_apply_pallas's limit: its tile, 8 MiB over taps x 8 channels x 4
# bytes, falls below 128 samples past 2048 taps; fir_os's too, whose
# OS_NFFT-point segment still gives 2,048 outputs there
KERNEL_MAX_TAPS = 2048
# resample_poly_pallas's up * taps_pp limit
POLY_MAX_WEIGHTS = poly_plan.POLY_MAX_WEIGHTS


def fir_direct_plain(h, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the direct FIR kernel: ``fir.fir_apply``."""
    return fir_apply(h, x)


@_build.counted
def fir_direct(h, x: torch.Tensor) -> torch.Tensor:
    """Causal FIR, lfilter(h, [1], x), (c, n) -> (c, n). Refuses taps where
    the JAX kernel does (its VMEM cap: taps > 2048). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (float32), or
    raises."""
    taps = np.shape(h)[-1]
    if not 1 <= taps <= KERNEL_MAX_TAPS:
        raise ValueError(f"taps={taps} outside the direct FIR kernel's range "
                         f"[1, {KERNEL_MAX_TAPS}]; use fir_apply_mxu")
    if x.device.type == "cpu":
        return fir_direct_plain(h, x)
    with profiling.span("kernel.fir_direct"):
        _build.require_rows(x, "fir_direct")
        # host taps come from the per-filter device cache, with no copy a call
        h = (taps_like(h, x).contiguous() if isinstance(h, torch.Tensor)
             else polyphase_table(h, 1, x.device)[0])
        _build.require(h, "h", x.device, (taps,))
        c, n = x.shape
        y = torch.empty_like(x)
        if n == 0:
            return y
        lib, dev, stream = _build.target(x)
        _build.launch(fir_direct, c, lambda r0, k: lib.vv_fir_direct(
            ptr(x, r0), ptr(h), ptr(y, r0), k, n, taps, dev, stream))
        return y


def os_geometry(taps: int) -> tuple[int, int]:
    """(lead, block) of fir_os's segments: segment b reads OS_NFFT samples
    from b * block - lead and gives the outputs b * block .. + block - 1.
    lead is taps - 1 rounded up to even and block = OS_NFFT - lead, so each
    segment starts at an even sample and its outputs at an even offset."""
    if not 1 <= taps <= KERNEL_MAX_TAPS:
        raise ValueError(f"taps={taps} outside fir_os's range "
                         f"[1, {KERNEL_MAX_TAPS}]")
    lead = taps - 1 + (taps - 1) % 2
    return lead, OS_NFFT - lead


def os_table_np(h, dtype=np.float32) -> np.ndarray:
    """(OS_NFFT/2, 4) table of fir_os: for bin k of the packed
    M-point transform (M = OS_NFFT/2), (conj alpha_k, conj beta_k), with
    Z'[k] = alpha_k Z[k] + beta_k conj Z[(M - k) mod M] the packed output's
    spectrum: the unpack, the product with the taps' OS_NFFT-point
    spectrum H, the repack and the 1/OS_NFFT of the inverse in one
    (``csrc/fir_os.cu``). Built in float64 and cast to dtype."""
    h = np.asarray(h, np.float64).reshape(-1)
    m = OS_NFFT // 2
    spec = np.fft.rfft(h, OS_NFFT)
    k = np.arange(m)
    hk, g = spec[:m], np.conj(spec[m - k])
    t = 2.0 * np.pi * k / OS_NFFT
    alpha = ((hk + g) - (hk - g) * np.sin(t)) / OS_NFFT
    beta = 1j * (hk - g) * np.cos(t) / OS_NFFT
    return np.stack([alpha.real, -alpha.imag, beta.real, -beta.imag],
                    axis=-1).astype(dtype)


@functools.lru_cache(maxsize=16)
def _os_table_on(h_key: bytes, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(os_table_np(np.frombuffer(h_key, np.float64)),
                           device=device)


def os_table(h, device) -> torch.Tensor:
    """os_table_np of taps h on `device`, built and put on the device once:
    for a tensor, kept for it per device beside its host taps
    (``_HOST_TAPS``: read back once, built again after an in-place write,
    dropped with the tensor); for host taps, cached per filter as the
    banded route's polyphase table is."""
    device = torch.device(device)
    if isinstance(h, torch.Tensor):
        return _HOST_TAPS.get(h, ("os_table", device), lambda: torch.as_tensor(
            os_table_np(_host_taps(h)), device=device))
    h_np = np.ascontiguousarray(np.asarray(h, np.float64).reshape(-1))
    return _os_table_on(h_np.tobytes(), device)


def fir_os_plain(x: torch.Tensor, table: torch.Tensor,
                 taps: int) -> torch.Tensor:
    """Plain version of the overlap-save kernel, its arithmetic in
    ``torch.fft``: each segment of os_geometry(taps) packed as complex
    points, its M-point FFT Z, conj Z' = table . (conj Z[k], Z[M - k]), the
    FFT of that conjugated, and the segment's block of outputs. (..., n)
    -> (..., n)."""
    lead, block = os_geometry(taps)
    m = OS_NFFT // 2
    n = x.shape[-1]
    nb = -(-n // block)
    xp = F.pad(x, (lead, (nb - 1) * block + OS_NFFT - lead - n))
    segs = xp.unfold(-1, OS_NFFT, block).contiguous()
    z = torch.view_as_complex(segs.reshape(segs.shape[:-1] + (m, 2)))
    tab = torch.view_as_complex(table.reshape(m, 2, 2))
    spec = torch.fft.fft(z)
    mirror = spec[..., (-torch.arange(m, device=x.device)) % m]
    w = torch.fft.fft(tab[:, 0] * spec.conj() + tab[:, 1] * mirror)
    w = w.conj().resolve_conj()
    y = torch.view_as_real(w).reshape(segs.shape)[..., lead:lead + block]
    return y.reshape(x.shape[:-1] + (nb * block,))[..., :n]


@_build.counted
def fir_os(x: torch.Tensor, table: torch.Tensor, taps: int) -> torch.Tensor:
    """Causal FIR, lfilter(h, [1], x), (c, n) -> (c, n), by overlap-save on
    OS_NFFT-point segments, one fused kernel: each segment's transform,
    its product with the taps' spectrum and its inverse stay on chip.
    table: ``os_table(h, x.device)``; taps: len(h), at most 2,048. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (float32), or raises."""
    lead, block = os_geometry(taps)
    if x.device.type == "cpu":
        return fir_os_plain(x, table, taps)
    with profiling.span("kernel.fir_os"):
        _build.require_rows(x, "fir_os")
        _build.require(table, "table", x.device, (OS_NFFT // 2, 4))
        c, n = x.shape
        y = torch.empty_like(x)
        if n == 0:
            return y
        tw = fft_plan.pass_twiddles(OS_NFFT // 2, x.device)
        lib, dev, stream = _build.target(x)
        _build.launch(fir_os, c, lambda r0, k: lib.vv_fir_os(
            ptr(x, r0), ptr(table), ptr(tw), ptr(y, r0), k, n, lead, block,
            dev, stream))
        return y


def resample_poly_plain(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Plain version of the per-phase kernel: ``resample.resample_poly``."""
    return resample_poly(x, up, down)


@_build.counted
def resample_poly_kernel(x: torch.Tensor, up: int,
                         down: int) -> torch.Tensor:
    """scipy.signal.resample_poly parity, (..., n) -> (..., ceil(n*up/down)),
    in the per-phase kernel. As resample_poly_pallas: up == down returns x,
    and a geometry with more than 512 weights (up * taps_pp) goes to
    ``resample.resample_poly`` (a static route, not a fallback). Otherwise
    a CPU tensor takes the plain version and a CUDA tensor launches the
    kernel (float32), or raises."""
    up, down = _reduce(up, down)
    if up == 1 and down == 1:
        return x
    h = _resample_poly_filter(up, down)
    if up * -(-len(h) // up) > POLY_MAX_WEIGHTS:
        return resample_poly(x, up, down)
    if x.device.type == "cpu":
        return resample_poly_plain(x, up, down)
    if x.ndim != 2:
        x2, restore = collapse_leading(x)
        return restore(resample_poly_kernel(x2, up, down), 1)
    with profiling.span("kernel.resample_poly_kernel"):
        _build.require_rows(x, "resample_poly_kernel")
        c, n_in = x.shape
        n_out = -(-n_in * up // down)
        y = torch.empty((c, n_out), dtype=torch.float32, device=x.device)
        if n_out == 0:
            return y
        p = poly_plan.poly_plan(up, down)
        weights, offsets = poly_plan.poly_tables(up, down, x.device)
        lib, dev, stream = _build.target(x)
        _build.launch(resample_poly_kernel, c, lambda r0, k: lib.vv_poly(
            ptr(x, r0), ptr(weights), ptr(offsets), ptr(y, r0), k, n_in,
            n_out, up, down, p.ncls, p.n_big, p.k, p.lo, p.row_len,
            p.q_pitch, p.p_pitch, p.frames, p.threads, p.smem, dev, stream))
        return y


def fir_apply_best(h, x: torch.Tensor) -> torch.Tensor:
    """Causal FIR, lfilter(h, [1], x), over the last axis, routed as the
    module docstring says. Span (while a
    profiler runs): ``fir`` around the call, one a call at any rank, timed
    on the device."""
    x = config.as_compute(x)
    with profiling.span("fir", device=x.device):
        if x.ndim != 2:
            x2, restore = collapse_leading(x)
            return restore(_fir_apply_best_2d(h, x2), 1)
        return _fir_apply_best_2d(h, x)


def _fir_apply_best_2d(h, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    taps = np.shape(h)[-1]
    calls = fir_apply_best.route_calls
    if taps <= DIRECT_MAX_TAPS:
        calls["direct"] += 1
        if isinstance(h, torch.Tensor):
            return kernel_with_torch_vjp(fir_direct, fir_direct_plain)(
                taps_like(h, x), x)
        return kernel_with_torch_vjp(lambda xv: fir_direct(h, xv),
                                     lambda xv: fir_direct_plain(h, xv))(x)
    learned = isinstance(h, torch.Tensor) and h.requires_grad
    if (OS_MIN_TAPS <= taps <= KERNEL_MAX_TAPS and not learned
            and config.dot_algorithm(None) == "f32"):
        calls["os"] += 1
        table = os_table(h, x.device)
        return kernel_with_torch_vjp(
            lambda xv: fir_os(xv, table, taps),
            lambda xv: fir_os_plain(xv, table, taps))(x)
    if (taps >= BANDED_MIN_TAPS and not learned
            and banded_supported(1, 1, taps, 0)):
        calls["banded"] += 1
        h_np = _host_taps(h)
        table = polyphase_table(h_np, 1, x.device)
        return kernel_with_torch_vjp(
            lambda xv: upfirdn_banded(xv, table, 1, 1, 0, xv.shape[-1]),
            lambda xv: fir_apply_mxu(h_np, xv),
        )(x)
    calls["mxu"] += 1
    return fir_apply_mxu(h, x)


# calls of each route, counted always (as SpectralGate.route_calls)
fir_apply_best.route_calls = dict.fromkeys(("direct", "mxu", "banded", "os"),
                                           0)


_HOST_TAPS = PerTensor()


def _host_taps(h) -> np.ndarray:
    """The taps as float64 on the host; a tensor's copy is kept for it
    (``PerTensor``), so taps on the card are read back once, not at every
    call."""
    if not isinstance(h, torch.Tensor):
        return np.asarray(h, np.float64)
    return _HOST_TAPS.get(h, None, lambda: h.detach().cpu().double().numpy())


def resample_poly_best(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """scipy.signal.resample_poly parity, routed as the JAX package routes
    on the TPU (module docstring)."""
    up_r, down_r = _reduce(up, down)
    if up_r == 1 and down_r == 1:
        return x
    x = config.as_compute(x)
    if x.ndim != 2:
        x2, restore = collapse_leading(x)
        return restore(resample_poly_best(x2, up_r, down_r), 1)
    x = x.contiguous()
    if up_r < 32:
        h = _resample_poly_filter(up_r, down_r)
        off = (len(h) - 1) // 2
        if banded_supported(up_r, down_r, len(h), off):
            n_out = -(-x.shape[-1] * up_r // down_r)
            table = polyphase_table(h, up_r, x.device)
            return kernel_with_torch_vjp(
                lambda xv: upfirdn_banded(xv, table, up_r, down_r, off,
                                          n_out),
                lambda xv: resample_poly_mxu(xv, up_r, down_r),
            )(x)
    return resample_poly_mxu(x, up_r, down_r)
