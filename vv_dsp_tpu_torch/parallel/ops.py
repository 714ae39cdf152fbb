"""Sharded DSP operators over a (channel, block) mesh: FIR, IIR, STFT and
its inverse, polyphase resampling, Savitzky-Golay and zero-phase FIR
(counterpart of ``vv_dsp_tpu/parallel/ops.py``).

Each computes the function of its dense counterpart in
``vv_dsp_tpu_torch.ops``; the seams between time-block shards are stitched
with the halo exchanges of ``parallel.halo``:

  op              halo
  ----------      -------------------------------------------------------
  FIR             taps - 1 from the left
  STFT analysis   nfft - hop from the right
  STFT synthesis  nfft - hop spilled to the right (data and w^2 norm)
  IIR             each shard's total affine map, composed over the shards
  resample_poly   taps_pp - 1 from the left, ceil(half_len / up) + 1 from
                  the right
  savgol/filtfilt window_length // 2 or taps - 1 each way, the global
                  edges padded in place

Global signals are (channels, time), spectra (channels, frames, bins):
channels split over the mesh's channel axis, time or frames over its block
axis (``sharded.shard``). The time length must divide evenly by the
block-shard count (``mesh.pad_to_blocks``). A shard's work runs on its own
device, the JAX shard_map body's ops in PyTorch; the STFT's runs on the
full-nfft spectrum kernel (``csrc/stockham.cu``) wherever its geometry
takes it. Under several processes each process walks the blocks it owns
(k stays the global block index) and the halos and the IIR's gathered
offsets cross processes through ``parallel.comm``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.ops import fir as _fir
from vv_dsp_tpu_torch.ops import framing as _framing
from vv_dsp_tpu_torch.ops import iir as _iir
from vv_dsp_tpu_torch.ops import resample as _resample
from vv_dsp_tpu_torch.ops import savgol as _savgol
from vv_dsp_tpu_torch.ops import stockham_kernels as _stk
from vv_dsp_tpu_torch.ops.window import get_window_np
from vv_dsp_tpu_torch.parallel import comm as _comm
from vv_dsp_tpu_torch.parallel import halo as _halo
from vv_dsp_tpu_torch.parallel.mesh import Mesh, process_index
from vv_dsp_tpu_torch.parallel.sharded import Row, ShardedTensor, shard
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp


@functools.lru_cache(maxsize=64)
def table_on(build, args: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """build(*args), a host numpy table, as a tensor on `device`: built and
    copied once for each key, which is made of the small arguments alone
    (hashing a large table on every call would cost more host time than
    the shard's work)."""
    return torch.as_tensor(np.array(build(*args)), dtype=dtype,
                           device=device)


def _from_bytes(data: bytes) -> np.ndarray:
    return np.frombuffer(data)


def window_on(window_np: np.ndarray, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """A float64 window as a tensor on `device`, copied once."""
    return table_on(_from_bytes, (np.asarray(window_np, np.float64)
                                  .tobytes(),), dtype, device)


def _rowwise(xs: ShardedTensor, fn, axis: int = -1) -> ShardedTensor:
    """fn(a ``Row`` of block shards) -> a row of outputs (None or a
    placeholder where this process does not hold the position), per
    row."""
    return ShardedTensor([fn(xs.row(i)) for i in range(len(xs.shards))],
                         axis, xs.owners)


def shard_channels(x: torch.Tensor, mesh: Mesh,
                   channel_axis: str = "channel") -> ShardedTensor:
    """The channel axis split over the mesh, time whole: the
    embarrassingly parallel layout, in which any op of
    ``vv_dsp_tpu_torch.ops`` runs shard by shard (``ShardedTensor.map``).
    Each channel block sits on the first device of its mesh row. Under
    several processes every process that owns a position of the row holds
    the block, on its first such device (as JAX replicates it over the
    block axis), and the owner of the row's first position sends it in
    ``gather``."""
    block_axis = next(a for a in mesh.axis_names if a != channel_axis)
    rows = mesh.grid(channel_axis, block_axis)
    owner_rows = mesh.owner_grid(channel_axis, block_axis)
    nc = len(rows)
    if x.shape[0] % nc:
        raise ValueError(f"{x.shape[0]} channels not divisible by {nc} "
                         "channel shards")
    me = process_index()
    return ShardedTensor(
        [[part.to(next(d for d, r in zip(devs, own) if r == me))
          if me in own else None]
         for part, devs, own in zip(x.split(x.shape[0] // nc, dim=0), rows,
                                    owner_rows)],
        -1, [(own[0],) for own in owner_rows])


# ---------------------------------------------------------------------------
# FIR: overlap-save with a left halo (the history ring buffer's stand-in)
# ---------------------------------------------------------------------------

def fir_apply_sharded(h, x, mesh: Mesh, channel_axis: str = "channel",
                      block_axis: str = "block",
                      use_fft: bool | None = None) -> ShardedTensor:
    """Causal FIR over a sharded time axis, the function of
    ``ops.fir.fir_apply``. Each shard takes taps - 1 samples of left halo
    (zeros on shard 0: zero initial history) and filters its extended
    block: overlap-save rfft with use_fft, block-Toeplitz matmuls
    (``fir_apply_mxu``) above 32 taps when use_fft is None, else a direct
    conv. h: numpy taps or a tensor (which stays differentiable)."""
    xs = shard(x, mesh, -1, channel_axis, block_axis)
    if not isinstance(h, torch.Tensor):
        h = np.asarray(h, dtype=np.float64)
    taps = h.shape[-1]

    def filt(k, xb, left):
        ext = torch.cat([left, xb], dim=-1)
        if use_fft:
            y = _fir.fir_apply_os(h, ext)
        elif use_fft is None and taps > 32:
            y = _fir.fir_apply_mxu(h, ext)
        else:
            y = _fir.fir_apply(h, ext)
        return y[..., taps - 1:]

    return _rowwise(xs, lambda row: row.each(
        filt, _halo.halo_from_left(row, taps - 1)))


# ---------------------------------------------------------------------------
# IIR: block-local scan, cross-shard affine composition
# ---------------------------------------------------------------------------

def iir_apply_sharded(sos, x, mesh: Mesh, channel_axis: str = "channel",
                      block_axis: str = "block") -> ShardedTensor:
    """Biquad cascade over a sharded time axis, the function of
    ``ops.iir.iir_apply``. Per section each shard scans its cumulative
    affine maps (A_cum, b_cum); the shards' total offsets b_tot are
    gathered over the row (JAX's ``all_gather``, across processes where
    the row spans several), the exclusive prefix over the shards gives
    each one its entry state (s_k = A_tot s_{k-1} + b_tot[k-1], with A_tot
    the same on every equal-length shard, so this process's own serves),
    computed in shard order on every process that owns a shard of the
    row, and each corrects its output with it."""
    xs = shard(x, mesh, -1, channel_axis, block_axis)
    sections = _iir.normalize_sos(sos)

    def run(row):
        mine = [k for k in range(len(row)) if row.local(k)]
        if not mine:
            return row
        y = list(row)
        for b0, b1, b2, a1, a2 in sections:
            cum = {k: _iir._biquad_cumulative(y[k], b0, b1, b2, a1, a2)
                   for k in mine}
            entries = {}
            if len(y) > 1:
                dev = y[mine[0]].device
                like = cum[mine[0]][1][..., -1, :].to("meta")
                tots = _comm.all_gather(
                    [cum[k][1][..., -1, :] if k in cum else like
                     for k in range(len(y))], row.owners, dev)
                a_loc = cum[mine[0]][0][..., -1, :, :].reshape(-1, 2, 2)[0]
                s = torch.zeros_like(tots[mine[0]])
                entries[0] = s
                for k in range(1, mine[-1] + 1):
                    s = (_iir._matvec(a_loc, s.to(dev))
                         + tots[k - 1].to(dev))
                    entries[k] = s
            for k in mine:
                s0 = entries.get(k)
                s0 = None if s0 is None else s0.to(y[k].device)
                y[k] = _iir._biquad_output(y[k], b0, s0, *cum[k])[0]
        return y

    return _rowwise(xs, run)


# ---------------------------------------------------------------------------
# STFT: analysis right halo, synthesis right spill
# ---------------------------------------------------------------------------

def stft_local(ext: torch.Tensor, nfft: int, hop: int, window: torch.Tensor,
               nf_local: int, rfft: bool = True) -> torch.Tensor:
    """Frames 0..nf_local-1 of one shard's extended block ext (its t_local
    samples and the nfft - hop of right halo; the last frame reads
    exactly those), windowed and transformed: (c, nf_local, bins).

    Where the geometry takes it (2-D real input, ``stockham_supported``)
    the spectrum is the full-nfft spectrum kernel's
    (``stockham_kernels.stft_spectrum_stockham``, kernel 9, whose plain
    version runs on a CPU tensor), cut to the shard's frames, with the
    framed transform's autograd rule; elsewhere the framed rfft/fft, or a
    gather framing where hop does not divide nfft."""
    if (ext.ndim == 2 and not ext.is_complex()
            and _stk.stockham_supported(nfft, hop)):
        def fast(ev):
            return _stk.stft_spectrum_stockham(ev, nfft, hop, window,
                                               onesided=rfft)[:, :nf_local]

        def ref(ev):
            frames = _framing.frames_strided(ev, nfft, hop, nf_local)
            frames = frames * window
            return _fft.rfft(frames) if rfft else _fft.fft(frames)

        return kernel_with_torch_vjp(fast, ref)(ext.contiguous())
    if nfft % hop == 0:
        frames = _framing.frames_strided(ext, nfft, hop, nf_local)
    else:
        frames = ext[..., table_on(_frame_index, (nf_local, nfft, hop),
                                   torch.int64, ext.device)]
    frames = frames * window
    return _fft.rfft(frames) if rfft else _fft.fft(frames)


def _frame_index(nf_local: int, nfft: int, hop: int) -> np.ndarray:
    return np.arange(nf_local)[:, None] * hop + np.arange(nfft)[None, :]


def stft_shards(xs: ShardedTensor, nfft: int, hop: int,
                window_np: np.ndarray, rfft: bool = True) -> ShardedTensor:
    """The frame-sharded STFT of a time-sharded signal, with a float64
    window; each shard must hold whole hops."""
    if xs.shards[0][0].shape[-1] % hop:
        raise ValueError("signal length must divide n_block_shards * hop "
                         "(or pass pad=True)")
    overlap = nfft - hop

    def spectrum(k, xb, right):
        w = window_on(window_np, xb.real.dtype, xb.device)
        return stft_local(torch.cat([xb, right], dim=-1), nfft, hop, w,
                          xb.shape[-1] // hop, rfft)

    return _rowwise(xs, lambda row: row.each(
        spectrum, _halo.halo_from_right(row, overlap)), axis=-2)


def stft_process_sharded(x, nfft: int, hop: int, mesh: Mesh,
                         window: str = "hann", rfft: bool = True,
                         channel_axis: str = "channel",
                         block_axis: str = "block",
                         pad: bool = False) -> ShardedTensor:
    """Forward STFT over a time-sharded signal, any hop <= nfft
    (src/spectral/stft.c:33 generality).

    x: (channels, n) with n % (n_block_shards * hop) == 0, so that frame
    ownership is uniform; pad=True zero-pads any n up to the next multiple
    (the reference's zero-padded tail frames, src/spectral/stft.c:124-137),
    gathering a ``ShardedTensor`` input first (a collective under several
    processes: every rank calls it).
    Shard k owns the frames starting inside its block and takes nfft - hop
    samples of right halo. Returns (channels, n // hop, bins) with the
    frame axis sharded over block_axis, ready for sharded spectral ops or
    ``stft_reconstruct_sharded``. The global frame count covers all tail
    frames; [..., :nf, :] is the reference's spectrogram count
    1 + (n - nfft + hop) // hop."""
    nb = mesh.shape[block_axis]
    if pad and x.shape[-1] % (nb * hop):
        if isinstance(x, ShardedTensor):
            x = x.gather()
        x = F.pad(x, (0, (-x.shape[-1]) % (nb * hop)))
    xs = shard(x, mesh, -1, channel_axis, block_axis)
    return stft_shards(xs, nfft, hop, get_window_np(window, nfft), rfft)


def reconstruct_shards(ss: ShardedTensor, nfft: int, hop: int,
                       window_np: np.ndarray,
                       rfft: bool = True) -> ShardedTensor:
    """The w^2-normalized overlap-add of a frame-sharded spectrum, with a
    float64 window."""
    overlap = nfft - hop
    ola = (_framing.overlap_add_strided if nfft % hop == 0
           else _framing.overlap_add)

    def both_and_spill(sb):
        """(recon and norm over the block, their spill past it), stacked;
        placeholders of their shapes where this process does not hold
        the block."""
        nf_local = sb.shape[-2]
        t_local = nf_local * hop
        if sb.is_meta:
            shape = (2,) + sb.shape[:-2]
            return (torch.empty(shape + (t_local,), dtype=sb.real.dtype,
                                device="meta"),
                    torch.empty(shape + (overlap,), dtype=sb.real.dtype,
                                device="meta"))
        time = _fft.irfft(sb, nfft) if rfft else _fft.ifft(sb).real
        w = window_on(window_np, torch.float32, sb.device).to(time.dtype)
        buf_len = t_local + overlap
        recon = ola(time * w, hop, buf_len)
        norm = ola((w * w).expand(nf_local, nfft), hop, buf_len)
        norm = norm.expand(recon.shape)
        return (torch.stack([recon[..., :t_local], norm[..., :t_local]]),
                torch.stack([recon[..., t_local:], norm[..., t_local:]]))

    def divide(k, both):
        recon, norm = both[0], both[1]
        good = norm > 1e-12
        return torch.where(
            good, recon / torch.where(good, norm, torch.ones_like(norm)),
            recon)

    def run(row):
        boths, spills = zip(*(both_and_spill(sb) for sb in row))
        summed = _halo.spill_add_right(Row(boths, row.owners), spills)
        return Row(summed, row.owners).each(divide)

    return _rowwise(ss, run)


def stft_reconstruct_sharded(spec, nfft: int, hop: int, mesh: Mesh,
                             window: str = "hann", rfft: bool = True,
                             channel_axis: str = "channel",
                             block_axis: str = "block") -> ShardedTensor:
    """Inverse STFT with the w^2-normalized overlap-add over a
    frame-sharded spectrum, as ``stft_process_sharded`` leaves it (any
    hop <= nfft; a hop not dividing nfft overlap-adds the zero-padded
    frames). Each shard overlap-adds its frames into t_local + nfft - hop
    samples, hands the tail spill of data and norm to the blocks on its
    right (``halo.spill_add_right``), and divides with the reference's
    1e-12 guard (tools/dump_stft_roundtrip.c:50-54). Returns (channels,
    frames * hop)."""
    ss = shard(spec, mesh, -2, channel_axis, block_axis)
    return reconstruct_shards(ss, nfft, hop, get_window_np(window, nfft),
                              rfft)


# ---------------------------------------------------------------------------
# Polyphase resampling: two-sided halo
# ---------------------------------------------------------------------------

def resample_poly_sharded(x, up: int, down: int, mesh: Mesh,
                          channel_axis: str = "channel",
                          block_axis: str = "block") -> ShardedTensor:
    """scipy-parity polyphase resampling over a sharded time axis.

    x: (channels, n) with n % (n_block_shards * down) == 0, so that every
    shard emits t_local * up / down samples. The centred anti-alias filter
    needs taps_pp - 1 samples of left halo and ceil(half_len / up) + 1 of
    right halo; the gather geometry is the same on every shard, since
    t_local * up is a multiple of up (``ops.resample._upfirdn_gather`` is
    the dense core this mirrors)."""
    g = math.gcd(up, down)
    up //= g
    down //= g
    if up == 1 and down == 1:
        return shard(x, mesh, -1, channel_axis, block_axis)
    nb = mesh.shape[block_axis]
    n = x.shape[-1]
    if n % (nb * down):
        raise ValueError("signal length must divide n_block_shards * down")
    half_len, hpp = resample_geometry(up, down)
    halo_l, halo_r = hpp.shape[1] - 1, -(-half_len // up) + 1
    key = (up, down, n // nb * up // down, halo_l)
    xs = shard(x, mesh, -1, channel_axis, block_axis)

    def resample(k, xb, left, right):
        ext = torch.cat([left, xb, right], dim=-1)
        gathered = ext[..., table_on(resample_index, key, torch.int64,
                                     xb.device)]
        return torch.einsum("...ot,ot->...o", gathered,
                            table_on(resample_weights, key, xb.dtype,
                                     xb.device))

    return _rowwise(xs, lambda row: row.each(
        resample, _halo.halo_from_left(row, halo_l),
        _halo.halo_from_right(row, halo_r)))


def polyphase_table(h: np.ndarray, up: int) -> np.ndarray:
    """hpp[p, i] = h[p + i*up], h zero-padded to whole phases."""
    taps_pp = -(-len(h) // up)
    h_pad = np.zeros(taps_pp * up)
    h_pad[:len(h)] = h
    return h_pad.reshape(taps_pp, up).T


@functools.lru_cache(maxsize=16)
def resample_geometry(up: int, down: int) -> tuple:
    """(half_len, polyphase table) of the scipy-parity filter (up/down
    reduced)."""
    h = _resample._resample_poly_filter(up, down)
    return (len(h) - 1) // 2, polyphase_table(h, up)


@functools.lru_cache(maxsize=16)
def _resample_plan(up: int, down: int, n_out: int, halo_l: int) -> tuple:
    """(gather index, weights) of a block's n_out outputs over its
    extension by halo_l samples of left halo: output j reads
    ext[anchor_j + halo_l - i] for tap i, anchor_j = (half_len + j*down)
    // up, the same on every shard."""
    half_len, hpp = resample_geometry(up, down)
    t = half_len + np.arange(n_out) * down
    idx = (t // up)[:, None] - np.arange(hpp.shape[1])[None, :] + halo_l
    return idx, hpp[t % up]


def resample_index(*key) -> np.ndarray:
    return _resample_plan(*key)[0]


def resample_weights(*key) -> np.ndarray:
    return _resample_plan(*key)[1]


# ---------------------------------------------------------------------------
# Savitzky-Golay and zero-phase FIR: two-sided halos
# ---------------------------------------------------------------------------

def _edge_fixed_row(row, halo: int, n_total: int,
                    reflect_mode: str) -> list[torch.Tensor]:
    """Each shard's two-sided window of the edge-padded global signal:
    positions [start - halo, start + t + halo) of the block starting at
    `start`, where out-of-signal positions follow `reflect_mode`:
    'reflect' pad[-i] = x[i] (savgol's, numpy's 'reflect'), 'symmetric'
    pad[-i] = x[i - 1] (filtfilt's, numpy's 'symmetric').

    halo may exceed the block. Every reflected position of an
    out-of-signal one in a shard's window lies within halo of the edge,
    inside the shard's own t + 2 halo window, so the fix-up is local.
    None where this process does not hold the block."""
    nb = len(row)
    t = row[0].shape[-1]
    reflect = reflect_mode == "reflect"

    def window(k, xb, left, right):
        ext = torch.cat([left, xb, right], dim=-1)
        # 'reflect' needs halo < t: reflecting position -halo reads x[halo],
        # which at halo == t lies in the neighbour shard
        if halo < t or (halo == t and not reflect):
            if halo and k == 0:
                refl = (xb[..., 1:halo + 1] if reflect else xb[..., :halo])
                ext = torch.cat([refl.flip(-1), ext[..., halo:]], dim=-1)
            if halo and k == nb - 1:
                refl = (xb[..., t - 1 - halo:t - 1] if reflect
                        else xb[..., t - halo:])
                ext = torch.cat([ext[..., :-halo], refl.flip(-1)], dim=-1)
            return ext
        # the halo spans several blocks: gather against the global edges
        return ext[..., table_on(_edge_index,
                                 (k * t, t, halo, n_total, reflect),
                                 torch.int64, xb.device)]

    return row.each(window, _halo.halo_from_left(row, halo),
                    _halo.halo_from_right(row, halo))


def _edge_index(start: int, t: int, halo: int, n_total: int,
                reflect: bool) -> np.ndarray:
    """Where each position of the window [start - halo, start + t + halo)
    reads within the window, the global edges reflected."""
    g = start - halo + np.arange(t + 2 * halo)
    if reflect:
        g = np.where(g < 0, -g, g)
        g = np.where(g >= n_total, 2 * n_total - 2 - g, g)
    else:
        g = np.where(g < 0, -g - 1, g)
        g = np.where(g >= n_total, 2 * n_total - 1 - g, g)
    return g - (start - halo)


def savgol_filter_sharded(x, window_length: int, polyorder: int, mesh: Mesh,
                          deriv: int = 0, delta: float = 1.0,
                          channel_axis: str = "channel",
                          block_axis: str = "block") -> ShardedTensor:
    """Sharded Savitzky-Golay, the function of ``ops.savgol.savgol_filter``
    with mode='reflect': window_length // 2 samples of halo on both sides
    (wider than a block too), the valid correlation of each extended
    block by block-Toeplitz matmuls."""
    half = window_length // 2
    w_np = _savgol.savgol_coeffs_np(window_length, polyorder, deriv, delta)
    n_total = x.shape[-1]
    if half >= n_total:
        raise ValueError("window_length//2 must be < signal length")
    xs = shard(x, mesh, -1, channel_axis, block_axis)
    taps = w_np[::-1].copy()
    return _rowwise(xs, lambda row: row.each(
        lambda k, xb, ext: _fir.fir_apply_mxu(taps, ext)[..., 2 * half:],
        _edge_fixed_row(row, half, n_total, "reflect")))


def filtfilt_fir_sharded(h, x, mesh: Mesh, channel_axis: str = "channel",
                         block_axis: str = "block") -> ShardedTensor:
    """Sharded zero-phase FIR (``ops.fir.filtfilt_fir``): symmetric global
    edge padding, then h forward and reversed, as one centred filter
    g = h * h[::-1] (the autocorrelation of h) over two-sided halos of
    taps - 1 samples (wider than a block too)."""
    h_np = np.asarray(h, dtype=np.float64)
    pad = h_np.shape[-1] - 1
    g = np.convolve(h_np, h_np[::-1])
    n_total = x.shape[-1]
    if pad >= n_total:
        raise ValueError("taps-1 must be < signal length")
    xs = shard(x, mesh, -1, channel_axis, block_axis)
    if pad == 0:
        return xs.map(lambda xb: xb * float(np.float32(g[0])))
    # y[i] = (g * xext)[i + 2 pad] with causal indexing
    return _rowwise(xs, lambda row: row.each(
        lambda k, xb, ext: _fir.fir_apply_mxu(g, ext)[..., 2 * pad:],
        _edge_fixed_row(row, pad, n_total, "symmetric")))
