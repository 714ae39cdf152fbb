"""IIR biquad cascades as associative scans, the block state-space form,
and Butterworth / Chebyshev design (counterpart of
``vv_dsp_tpu/ops/iir.py``; the reference's src/filter/iir.c).

The reference runs a Direct-Form-II-Transposed biquad per sample
(src/filter/iir.c:21-43):
    y  = b0 x + z1
    z1 = b1 x - a1 y + z2
    z2 = b2 x - a2 y
which is linear in the state s = (z1, z2):
    s' = A s + B x,   A = [[-a1, 1], [-a2, 0]],  B = [b1 - a1 b0, b2 - a2 b0]
    y  = b0 x + s_prev[0].
A run is a scan over the affine maps (A, B x_t) with composition (f then g)
= (g.A f.A, g.A f.b + g.b). PyTorch has no public associative scan, so
``associative_scan`` is JAX's odd-even recursion written in tensor ops:
combine adjacent pairs, scan the half, combine the odd results with the
even inputs. It forms the same combine tree as ``lax.associative_scan``,
so the two round alike. The combines run at the matmul-precision knob's
tier; at "highest" (f32) a 2x2 product is written per element, rounded
as XLA's float32 dot rounds it (``_dot``), with no batched GEMM launch per
level.

``iir_apply`` takes the block state-space path (``_iir_apply_block``) where
``_block_path_ok`` holds (n >= 8192, at most 8 sections, pole radius <= 1):
the cascade as one LTI system, blocks of 512 samples as one dense matmul,
block states coupled by an affine scan over the ~n/512 blocks. Otherwise it
scans each section in turn. The route depends on the geometry and the
design alone, and is the same on every device.

The designers are float64 numpy copies of the JAX package's. Parity
contract: scipy.signal.sosfilt/lfilter within 3e-3 (python/test_filters.py
:32-33).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from vv_dsp_tpu_torch import config


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def _take(t: torch.Tensor, dim: int, start: int, stop=None,
          step: int = 1) -> torch.Tensor:
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                dim: int) -> torch.Tensor:
    """e0 o0 e1 o1 ... along dim (len(even) is len(odd) or one more)."""
    shape = list(even.shape)
    shape[dim] = even.shape[dim] + odd.shape[dim]
    out = even.new_empty(shape)
    out[(slice(None),) * dim + (slice(0, None, 2),)] = even
    out[(slice(None),) * dim + (slice(1, None, 2),)] = odd
    return out


def associative_scan(combine, elems, dim: int):
    """Inclusive scan of the tuple of tensors `elems` along the
    non-negative axis `dim`, ``lax.associative_scan``'s recursion:
    combine(earlier, later) takes and returns tuples of tensors."""
    n = elems[0].shape[dim]
    if n < 2:
        return tuple(elems)
    reduced = combine(tuple(_take(e, dim, 0, -1, 2) for e in elems),
                      tuple(_take(e, dim, 1, None, 2) for e in elems))
    odd = associative_scan(combine, reduced, dim)
    evens_in = tuple(_take(e, dim, 2, None, 2) for e in elems)
    if n % 2 == 0:
        even = combine(tuple(_take(e, dim, 0, -1) for e in odd), evens_in)
    else:
        even = combine(odd, evens_in)
    even = tuple(torch.cat([_take(e, dim, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last two axes at the knob's tier. At f32 with an
    inner dimension of 2 (a biquad's) it is written per element and
    rounds as XLA's float32 dot does: the second product fused onto the
    rounded first, fma(a1, b1, a0 b0), with float64 holding the fused
    product and sum exactly. The JAX package's combines round so on the
    CPU, which keeps the two scans within float32 rounding of each other
    even where the poles sit near the unit circle."""
    if (a.shape[-1] == 2 and a.dtype == torch.float32
            and config.dot_algorithm(None) == "f32"):
        first = (a[..., :, :1] * b[..., :1, :]).double()
        second = a[..., :, 1:].double() * b[..., 1:, :].double()
        return (second + first).float()
    return config.tier_matmul(a, b, None)


def _matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _dot(a, v.unsqueeze(-1)).squeeze(-1)


def _affine_combine(f, g):
    """(f then g) of affine maps s -> A s + b."""
    fa, fb = f
    ga, gb = g
    return _dot(ga, fa), _matvec(ga, fb) + gb


def _float(x: torch.Tensor) -> torch.Tensor:
    # integer input would truncate the coefficients
    return x if x.is_floating_point() else x.float()


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _biquad_cumulative(x: torch.Tensor, b0, b1, b2, a1, a2):
    """Cumulative affine maps of one biquad over the last axis.

    x: (..., n). Returns (A_cum (..., n, 2, 2), b_cum (..., n, 2)) such
    that the state after sample t from entry state s0 is
    A_cum[t] s0 + b_cum[t]."""
    x = _float(x)
    b0, b1, b2, a1, a2 = map(float, (b0, b1, b2, a1, a2))
    a = torch.tensor([[-a1, 1.0], [-a2, 0.0]], dtype=x.dtype,
                     device=x.device)
    bv = torch.tensor([b1 - a1 * b0, b2 - a2 * b0], dtype=x.dtype,
                      device=x.device)
    bs = x[..., None] * bv
    as_ = a.expand(x.shape + (2, 2))
    return associative_scan(_affine_combine, (as_, bs), x.ndim - 1)


def _biquad_output(x: torch.Tensor, b0, s_init, a_cum: torch.Tensor,
                   b_cum: torch.Tensor):
    """DF2T output from the cumulative maps, y_t = b0 x_t + z1_{t-1}.
    s_init: None (zero state) or (..., 2). Returns (y, final state)."""
    if s_init is None:
        s_after = b_cum
        prev_z1 = F.pad(s_after[..., :-1, 0], (1, 0))
    else:
        s_init = s_init.to(b_cum.dtype)
        s_after = b_cum + _matvec(a_cum, s_init[..., None, :])
        first = s_init[..., 0:1].expand(s_after[..., :1, 0].shape)
        prev_z1 = torch.cat([first, s_after[..., :-1, 0]], dim=-1)
    y = float(b0) * _float(x) + prev_z1
    return y, s_after[..., -1, :]


def _biquad_scan(x: torch.Tensor, b0, b1, b2, a1, a2, s_init=None):
    """One biquad over the last axis by the scan: (y, final (z1, z2))."""
    a_cum, b_cum = _biquad_cumulative(x, b0, b1, b2, a1, a2)
    return _biquad_output(x, b0, s_init, a_cum, b_cum)


def normalize_sos(sos) -> np.ndarray:
    """SOS as (n_stages, 5) float64 rows [b0 b1 b2 a1 a2] with a0 divided
    out (takes scipy's (n, 6) layout)."""
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim == 1:
        sos = sos[None, :]
    out = []
    for row in sos:
        if row.shape[0] == 6:
            b0, b1, b2, a0, a1, a2 = row
            if abs(a0 - 1.0) > 1e-12:
                b0, b1, b2, a1, a2 = (b0 / a0, b1 / a0, b2 / a0, a1 / a0,
                                      a2 / a0)
        else:
            b0, b1, b2, a1, a2 = row
        out.append((b0, b1, b2, a1, a2))
    return np.asarray(out)


def biquad_apply(x: torch.Tensor, b0, b1, b2, a1, a2,
                 s_init=None) -> torch.Tensor:
    """Single-biquad DF2T filter (vv_dsp_biquad_process semantics)."""
    y, _ = _biquad_scan(x, b0, b1, b2, a1, a2, s_init)
    return y


_BLOCK_B = 512          # block length of the block state-space path
_BLOCK_MIN_N = 8192     # below this the per-section scan is taken


@functools.lru_cache(maxsize=32)
def _cascade_block_constants(sos_key, b_len: int):
    """Float64 constants of the block state-space IIR.

    The SOS cascade is one LTI system s' = A s + Bv u, y = Cv s + D u with
    state dimension S = 2 n_sections. In blocks of b_len samples:
      y_block = T x_block + R s_entry   (T[i, j] = h[i - j], the cascade's
                                         impulse response, exact within a
                                         block; R[i] = Cv A^i)
      c_block = F^T x_block             (F[j] = A^(b-1-j) Bv)
      s_next  = A^b s_entry + c_block.
    Returns (Wcat (b+S, b) = [T; F^T], R (b, S), A^b (S, S), the largest
    pole magnitude): the powers of A stay representable only for stable or
    marginally stable designs."""
    sos = np.asarray(sos_key, dtype=np.float64).reshape(-1, 5)
    A = np.zeros((0, 0))
    Bv = np.zeros((0,))
    Cv = np.zeros((0,))
    D = 1.0
    for b0, b1, b2, a1, a2 in sos:
        Ai = np.array([[-a1, 1.0], [-a2, 0.0]])
        Bi = np.array([b1 - a1 * b0, b2 - a2 * b0])
        Ci = np.array([1.0, 0.0])
        Di = b0
        s_old = A.shape[0]
        A_new = np.zeros((s_old + 2, s_old + 2))
        A_new[:s_old, :s_old] = A
        A_new[s_old:, :s_old] = np.outer(Bi, Cv)
        A_new[s_old:, s_old:] = Ai
        B_new = np.concatenate([Bv, Bi * D])
        C_new = np.concatenate([Di * Cv, Ci])
        A, Bv, Cv, D = A_new, B_new, C_new, D * Di
    S = A.shape[0]
    radius = float(np.abs(np.linalg.eigvals(A)).max()) if S else 0.0

    h = np.zeros(b_len)
    F_ = np.zeros((b_len, S))
    R = np.zeros((b_len, S))
    h[0] = D
    Ak = np.eye(S)                      # A^i
    for i in range(b_len):
        R[i] = Cv @ Ak
        if i + 1 < b_len:
            h[i + 1] = Cv @ (Ak @ Bv)
        Ak = Ak @ A
    Ab = Ak                              # A^b_len
    acc = Bv.copy()                      # F[j] = A^(b-1-j) Bv, backwards
    for j in range(b_len - 1, -1, -1):
        F_[j] = acc
        acc = A @ acc
    i_idx = np.arange(b_len)[:, None]
    j_idx = np.arange(b_len)[None, :]
    T = np.where(i_idx >= j_idx, h[np.clip(i_idx - j_idx, 0, b_len - 1)], 0.0)
    wcat = np.concatenate([T, F_.T], axis=0)   # (b+S, b)
    return wcat, R, Ab, radius


@functools.lru_cache(maxsize=32)
def _block_constants_on(sos_key, b_len: int, dtype: torch.dtype,
                        device: torch.device):
    """(Wcat^T (b, b+S), R^T (S, b), A^b (S, S)) as `dtype` on `device`."""
    wcat, r, ab, _ = _cascade_block_constants(sos_key, b_len)
    return tuple(torch.as_tensor(np.ascontiguousarray(t), dtype=dtype,
                                 device=device)
                 for t in (wcat.T, r.T, ab))


def _sos_key(sos_n: np.ndarray):
    return tuple(map(tuple, sos_n.tolist()))


def _iir_apply_block(sos_n: np.ndarray, x: torch.Tensor, zi):
    """Block state-space cascade: one (b+S, b) product per block and an
    affine scan over the block states. Returns (y, final cascade state
    (..., S))."""
    b_len = _BLOCK_B
    key = _sos_key(sos_n)
    n_sec = sos_n.shape[0]
    S = 2 * n_sec
    x = _float(x)
    dt, dev = x.dtype, x.device
    wcat_t, r_t, ab = _block_constants_on(key, b_len, dt, dev)

    lead = tuple(x.shape[:-1])
    n = x.shape[-1]
    nb = -(-n // b_len)
    xb = F.pad(x, (0, nb * b_len - n)).reshape(lead + (nb, b_len))
    prod = config.tier_matmul(xb, wcat_t, None)
    zsr, c = prod[..., :b_len], prod[..., b_len:]

    # entry state per block: s_{m+1} = A^b s_m + c_m, an affine scan
    a_cum, b_cum = associative_scan(
        _affine_combine, (ab.expand(lead + (nb, S, S)), c), len(lead))
    if zi is None:
        s_after = b_cum
        s_entry = F.pad(s_after[..., :-1, :], (0, 0, 1, 0))
    else:
        # scipy-style unbatched (n_sections, 2) zi broadcasts to the batch
        zi_b = torch.as_tensor(zi, dtype=dt, device=dev).expand(
            lead + (n_sec, 2))
        s0 = zi_b.reshape(lead + (S,))
        s_after = b_cum + _matvec(a_cum, s0[..., None, :])
        s_entry = torch.cat([s0[..., None, :], s_after[..., :-1, :]],
                            dim=-2)
    s_last = s_after[..., -1, :]
    y = zsr + config.tier_matmul(s_entry, r_t, None)
    y = y.reshape(lead + (nb * b_len,))[..., :n]
    if n % b_len:
        # the exact end state: the partial block's transition over its real
        # samples only (A^(tail-1-j) Bv and A^tail from the host tables)
        m_last = n // b_len
        tail_len = n - m_last * b_len
        wt_t, _, ab_t = _block_constants_on(key, tail_len, dt, dev)
        c_t = config.tier_matmul(x[..., m_last * b_len:], wt_t[:, tail_len:],
                                 None)
        s_last = _matvec(ab_t, s_entry[..., m_last, :]) + c_t
    return y, s_last


def _block_path_ok(sos_n: np.ndarray, n: int) -> bool:
    if n < _BLOCK_MIN_N or sos_n.shape[0] > 8:
        return False
    _, _, _, radius = _cascade_block_constants(_sos_key(sos_n), _BLOCK_B)
    return radius <= 1.0 + 1e-9


def iir_apply(sos, x: torch.Tensor, return_state: bool = False, zi=None):
    """Biquad cascade (vv_dsp_iir_apply, src/filter/iir.c:29-43;
    scipy.signal.sosfilt's role).

    sos: (n_stages, 6) scipy-style [b0 b1 b2 a0 a1 a2], or (n_stages, 5)
    reference-style [b0 b1 b2 a1 a2]. zi: optional (..., n_stages, 2)
    per-stage DF2T entry state (z1, z2), scipy's sosfilt(zi=...). Long
    signals of stable designs take the block state-space path; others
    scan each section (``_block_path_ok``)."""
    sos_n = normalize_sos(sos)
    n = x.shape[-1]
    if _block_path_ok(sos_n, n):
        y, s = _iir_apply_block(sos_n, x, zi)
        if return_state:
            return y, s.reshape(s.shape[:-1] + (sos_n.shape[0], 2))
        return y
    if zi is not None:
        zi = torch.as_tensor(zi, device=x.device)
    states = []
    y = x
    for k, (b0, b1, b2, a1, a2) in enumerate(sos_n.tolist()):
        s0 = None if zi is None else zi[..., k, :]
        y, s = _biquad_scan(y, b0, b1, b2, a1, a2, s_init=s0)
        states.append(s)
    if return_state:
        return y, torch.stack(states, dim=-2)
    return y


def sosfilt_zi_np(sos) -> np.ndarray:
    """scipy.signal.sosfilt_zi: each stage's DF2T steady state for a unit
    step, scaled by the DC gain of the stages before it. Float64,
    (n_stages, 2)."""
    sos = normalize_sos(sos)
    zis = np.empty((len(sos), 2), dtype=np.float64)
    scale = 1.0
    for k, (b0, b1, b2, a1, a2) in enumerate(sos):
        A = np.array([[-a1, 1.0], [-a2, 0.0]])
        B = np.array([b1 - a1 * b0, b2 - a2 * b0])
        zis[k] = scale * np.linalg.solve(np.eye(2) - A, B)
        scale *= (b0 + b1 + b2) / (1.0 + a1 + a2)  # the stage's DC gain
    return zis


def filtfilt_sos(sos, x: torch.Tensor,
                 padlen: int | None = None) -> torch.Tensor:
    """Zero-phase IIR, scipy.signal.sosfiltfilt's: odd-reflect padding,
    steady-state initial conditions, the cascade forward and backward."""
    sos = normalize_sos(sos)
    n = x.shape[-1]
    if padlen is None:
        ntaps = 2 * len(sos) + 1
        ntaps -= int(min((sos[:, 2] == 0).sum(), (sos[:, 4] == 0).sum()))
        padlen = 3 * ntaps  # scipy's default edge size
    if padlen >= n:
        raise ValueError(f"signal length {n} must exceed padlen {padlen}")
    x = _float(torch.as_tensor(x))
    if padlen > 0:
        left = 2.0 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
        right = 2.0 * x[..., -1:] - x[..., -padlen - 1:-1].flip(-1)
        ext = torch.cat([left, x, right], dim=-1)
    else:
        ext = x
    zi = torch.as_tensor(sosfilt_zi_np(sos), dtype=ext.dtype,
                         device=ext.device)
    fwd = iir_apply(sos, ext, zi=zi * ext[..., :1, None])
    rev = fwd.flip(-1)
    out = iir_apply(sos, rev, zi=zi * rev[..., :1, None]).flip(-1)
    return out[..., padlen:padlen + n] if padlen > 0 else out


def lfilter(b, a, x: torch.Tensor) -> torch.Tensor:
    """scipy.signal.lfilter for any order: order <= 2 as one biquad scan
    at any length (the reference's tools/dump_iir.c path), higher orders
    as the ``tf2sos`` cascade through ``iir_apply``. Parity contract:
    scipy.signal.lfilter within 3e-3."""
    b = np.asarray(b, dtype=np.float64)
    a = np.asarray(a, dtype=np.float64)
    b = b / a[0]
    a = a / a[0]
    if len(a) <= 3 and len(b) <= 3:
        b = np.pad(b, (0, 3 - len(b)))
        a = np.pad(a, (0, 3 - len(a)))
        return biquad_apply(x, b[0], b[1], b[2], a[1], a[2])
    return iir_apply(tf2sos(b, a), x)


# ---------------------------------------------------------------------------
# design (float64 numpy, copies of the JAX package's)
# ---------------------------------------------------------------------------

def _bilinear_zpk(z, p, k, fs=2.0):
    fs2 = 2.0 * fs
    z = np.asarray(z, dtype=np.complex128)
    p = np.asarray(p, dtype=np.complex128)
    degree = len(p) - len(z)
    zb = (fs2 + z) / (fs2 - z)
    pb = (fs2 + p) / (fs2 - p)
    zb = np.append(zb, -np.ones(degree))
    kb = k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))
    return zb, pb, kb


def _butter_prototype(order: int):
    k = np.arange(order)
    poles = np.exp(1j * np.pi * (2 * k + order + 1) / (2 * order))
    return np.array([]), poles, 1.0


def _cheby1_prototype(order: int, rp: float):
    eps = np.sqrt(10.0 ** (rp / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / order
    k = np.arange(order)
    theta = np.pi * (2 * k + 1) / (2 * order)
    poles = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    gain = np.real(np.prod(-poles))
    if order % 2 == 0:
        gain /= np.sqrt(1.0 + eps * eps)
    return np.array([]), poles, gain


def _cheby2_prototype(order: int, rs: float):
    de = 1.0 / np.sqrt(10.0 ** (rs / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / de) / order
    k = np.arange(order)
    theta = np.pi * (2 * k + 1) / (2 * order)
    # zeros on the imaginary axis at sec(theta); odd order drops the
    # middle (infinite) zero
    if order % 2:
        mask = np.arange(order) != order // 2
    else:
        mask = np.ones(order, bool)
    zeros = 1j / np.cos(theta[mask]) * -1.0
    zeros = np.conj(zeros)
    poles = 1.0 / (-np.sinh(mu) * np.sin(theta)
                   + 1j * np.cosh(mu) * np.cos(theta))
    gain = np.real(np.prod(-poles) / np.prod(-zeros))
    return zeros, poles, gain


def _lp2lp_zpk(z, p, k, wo):
    degree = len(p) - len(z)
    return z * wo, p * wo, k * wo ** degree


def _lp2hp_zpk(z, p, k, wo):
    degree = len(p) - len(z)
    zh = wo / z if len(z) else np.array([], dtype=np.complex128)
    ph = wo / p
    zh = np.append(zh, np.zeros(degree))
    kh = k * np.real(np.prod(-z) / np.prod(-p)) if len(z) else k * np.real(
        1.0 / np.prod(-p)
    )
    return zh, ph, kh


def _lp2bp_zpk(z, p, k, wo, bw):
    """Lowpass prototype -> bandpass: s -> (s^2 + wo^2)/(bw s). Each root r
    splits into r bw/2 +- sqrt((r bw/2)^2 - wo^2); the `degree` missing
    zeros land at the origin; the gain scales by bw^degree."""
    z = np.asarray(z, dtype=np.complex128)
    p = np.asarray(p, dtype=np.complex128)
    degree = len(p) - len(z)
    zs = z * (bw / 2.0)
    ps = p * (bw / 2.0)
    zb = np.concatenate([zs + np.sqrt(zs ** 2 - wo ** 2),
                         zs - np.sqrt(zs ** 2 - wo ** 2)])
    pb = np.concatenate([ps + np.sqrt(ps ** 2 - wo ** 2),
                         ps - np.sqrt(ps ** 2 - wo ** 2)])
    zb = np.append(zb, np.zeros(degree))
    kb = k * bw ** degree
    return zb, pb, kb


def _lp2bs_zpk(z, p, k, wo, bw):
    """Lowpass prototype -> bandstop: s -> bw s/(s^2 + wo^2). Roots invert
    to (bw/2)/r and split as for bandpass; the `degree` missing zeros land
    at +-j wo (the notch); the gain takes real(prod(-z)/prod(-p))."""
    z = np.asarray(z, dtype=np.complex128)
    p = np.asarray(p, dtype=np.complex128)
    degree = len(p) - len(z)
    zs = (bw / 2.0) / z if len(z) else np.array([], dtype=np.complex128)
    ps = (bw / 2.0) / p
    zb = np.concatenate([zs + np.sqrt(zs ** 2 - wo ** 2),
                         zs - np.sqrt(zs ** 2 - wo ** 2)]) if len(zs) else (
        np.array([], dtype=np.complex128))
    pb = np.concatenate([ps + np.sqrt(ps ** 2 - wo ** 2),
                         ps - np.sqrt(ps ** 2 - wo ** 2)])
    zb = np.concatenate([zb, np.full(degree, 1j * wo),
                         np.full(degree, -1j * wo)])
    num = np.real(np.prod(-z)) if len(z) else 1.0
    kb = k * num / np.real(np.prod(-p))
    return zb, pb, kb


def _pair_conjugates(vals):
    """Sort complex values into conjugate pairs (and at most one real left
    over for an odd count): a list of 1- or 2-element arrays."""
    vals = np.asarray(vals, dtype=np.complex128)
    used = np.zeros(len(vals), dtype=bool)
    pairs = []
    order = np.argsort(-np.abs(vals))  # pair near the unit circle first
    for i in order:
        if used[i]:
            continue
        used[i] = True
        if abs(vals[i].imag) < 1e-10 * max(1.0, abs(vals[i].real)):
            j = next((jj for jj in order if not used[jj]
                      and abs(vals[jj].imag)
                      < 1e-10 * max(1.0, abs(vals[jj].real))), None)
            if j is None:
                pairs.append(np.array([vals[i]]))
            else:
                used[j] = True
                pairs.append(np.array([vals[i], vals[j]]))
        else:
            conj = np.conj(vals[i])
            j = min((jj for jj in order if not used[jj]),
                    key=lambda jj: abs(vals[jj] - conj), default=None)
            if j is None or abs(vals[j] - conj) > 1e-6 * max(1.0, abs(conj)):
                raise ValueError("unpaired complex root")
            used[j] = True
            pairs.append(np.array([vals[i], vals[j]]))
    return pairs


def zpk2sos(z, p, k, distribute_gain: bool = True):
    """Pair zeros and poles into second-order sections
    (scipy.signal.zpk2sos's role): pole pairs take their nearest zero
    pairs, poles nearest the unit circle choosing first; sections are
    ordered with those poles last; the gain is spread geometrically
    (|k|^(1/n) a section). Zero pairs left over become FIR sections."""
    z = np.asarray(z, dtype=np.complex128)
    p = np.asarray(p, dtype=np.complex128)
    ppairs = _pair_conjugates(p) if len(p) else []
    zpairs = _pair_conjugates(z) if len(z) else []

    def closeness(pair):  # distance to the unit circle
        return min(abs(1.0 - np.abs(v)) for v in pair)

    order = sorted(range(len(ppairs)), key=lambda i: closeness(ppairs[i]))
    remaining = list(zpairs)
    assigned: dict[int, np.ndarray] = {}
    for i in order:
        if remaining:
            cen = np.mean(ppairs[i])
            j = min(range(len(remaining)),
                    key=lambda t: abs(np.mean(remaining[t]) - cen))
            assigned[i] = remaining.pop(j)
        else:
            assigned[i] = np.array([])
    section_pairs = [(np.array([]), zz) for zz in remaining]
    section_pairs += [(ppairs[i], assigned[i]) for i in reversed(order)]

    ns = max(len(section_pairs), 1)
    if distribute_gain and k != 0.0:
        g = float(abs(k)) ** (1.0 / ns)
        gains = [g] * ns
        gains[0] *= 1.0 if k > 0 else -1.0
    else:
        gains = [float(k)] + [1.0] * (ns - 1)

    sos = []
    for i, (pp, zz) in enumerate(section_pairs):
        bpoly = np.real(np.poly(zz)) if len(zz) else np.array([1.0])
        apoly = np.real(np.poly(pp)) if len(pp) else np.array([1.0])
        b = np.zeros(3)
        a = np.zeros(3)
        b[: len(bpoly)] = bpoly * gains[i]
        a[: len(apoly)] = apoly
        sos.append(np.concatenate([b, a]))
    if not sos:
        sos.append(np.array([float(k), 0, 0, 1, 0, 0]))
    return np.asarray(sos)


def tf2zpk(b, a):
    """Transfer function -> (zeros, poles, gain, n_delay): n_delay counts
    the leading zeros of b, a z^-n_delay factor that ``tf2sos`` appends as
    delay sections."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    if a[0] == 0.0:
        raise ValueError("a[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    nz = np.nonzero(np.abs(b) > 0.0)[0]
    if len(nz) == 0:
        return np.array([]), np.array([]), 0.0, 0
    n_delay = int(nz[0])
    b = b[n_delay:]
    k = float(b[0])
    z = np.roots(b / b[0]) if len(b) > 1 else np.array([])
    p = np.roots(a) if len(a) > 1 else np.array([])
    return z, p, k, n_delay


def tf2sos(b, a):
    """Any-order (b, a) -> SOS cascade (scipy.signal.tf2sos's role)."""
    z, p, k, n_delay = tf2zpk(b, a)
    sos = zpk2sos(z, p, k)
    for _ in range(n_delay):
        sos = np.vstack([sos, [0.0, 1.0, 0.0, 1.0, 0.0, 0.0]])
    return sos


def _design(proto, btype: str, wn):
    z, p, k = proto
    fs = 2.0
    wn = np.atleast_1d(np.asarray(wn, dtype=np.float64))
    warped = 2.0 * fs * np.tan(np.pi * wn / fs)
    if btype in ("lowpass", "highpass"):
        if wn.size != 1:
            raise ValueError(f"{btype} needs a scalar wn")
        if btype == "lowpass":
            z, p, k = _lp2lp_zpk(z, p, k, warped[0])
        else:
            z, p, k = _lp2hp_zpk(z, p, k, warped[0])
    elif btype in ("bandpass", "bandstop"):
        if wn.size != 2 or not wn[0] < wn[1]:
            raise ValueError(f"{btype} needs wn = (low, high) with low < high")
        bw = warped[1] - warped[0]
        wo = float(np.sqrt(warped[0] * warped[1]))
        if btype == "bandpass":
            z, p, k = _lp2bp_zpk(z, p, k, wo, bw)
        else:
            z, p, k = _lp2bs_zpk(z, p, k, wo, bw)
    else:
        raise ValueError(
            "btype must be lowpass/highpass/bandpass/bandstop")
    z, p, k = _bilinear_zpk(z, p, k, fs)
    return zpk2sos(z, p, k)


def butter_sos(order: int, wn, btype: str = "lowpass") -> np.ndarray:
    """Butterworth digital design -> (sections, 6) SOS, wn normalized to
    Nyquist as scipy.signal.butter(order, wn, btype, output='sos');
    bandpass and bandstop take wn = (low, high)."""
    return _design(_butter_prototype(order), btype, wn)


def cheby1_sos(order: int, rp: float, wn,
               btype: str = "lowpass") -> np.ndarray:
    """Chebyshev-I digital design -> SOS (scipy.signal.cheby1's)."""
    return _design(_cheby1_prototype(order, rp), btype, wn)


def cheby2_sos(order: int, rs: float, wn,
               btype: str = "lowpass") -> np.ndarray:
    """Chebyshev-II digital design -> SOS (scipy.signal.cheby2's)."""
    return _design(_cheby2_prototype(order, rs), btype, wn)
