"""Distributed FFT over the block-sharded time axis, and the sharded
Hilbert transform and real cepstrum (counterpart of
``vv_dsp_tpu/parallel/fft.py``).

The four-step Cooley-Tukey factorization N = N1 * N2 with N1 the number
of block shards:

  shard n1 holds x[n1*N2 : (n1+1)*N2]            (natural block layout)
  step A: a DFT across the shards over the block index
            A[k1, n2] = sum_n1 x[n1, n2] W_N1^{n1 k1}
  step B: the local twiddle  B = A * W_N^{n2 k1}
  step C: a local length-N2 FFT over n2

gives X[k1 + N1*k2] on shard k1: a cyclic frequency layout (shard k1 owns
the bins congruent to k1 mod N1). Pointwise spectral filters (the Hilbert
one-sided mask, the cepstrum's log magnitude) evaluate at each local
element's global bin, so they need no exchange in this layout;
``ifft_sharded`` returns to the natural block layout.

Where the JAX package reduce-scatters (``psum_scatter``), the port forms
each target shard's sum over the source shards on the target's device,
copying each source there; under several processes every block of a row
first crosses once to each other process that owns a block of that row
(``comm.all_gather``), and each process forms the sums of its own
shards in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from vv_dsp_tpu_torch.ops import fft as _fft
from vv_dsp_tpu_torch.parallel import comm as _comm
from vv_dsp_tpu_torch.parallel.mesh import Mesh
from vv_dsp_tpu_torch.parallel.sharded import Row, ShardedTensor, shard


def _block_dft(row: Row, sign: float) -> list:
    """The DFT across one row's shards over the block index: shard k1
    receives sum_s W^{sign s k1} x_s (s = 0..nb-1 in order), with the phase
    formed in float32 as the JAX package forms it; the placeholder stays
    where this process does not hold k1."""
    nb = len(row)
    if nb == 1:
        return list(row)
    mine = [k for k in range(nb) if row.local(k)]
    blocks = _comm.all_gather(row, row.owners,
                              row[mine[0]].device if mine else None)
    step = np.float32(sign * 2.0 * np.pi / nb)

    def dft(k1, target):
        acc = None
        for s, src in enumerate(blocks):
            ang = np.float32(step * np.float32(s)) * np.float32(k1)
            term = src.to(target.device) * complex(np.cos(ang), np.sin(ang))
            acc = term if acc is None else acc + term
        return acc

    return row.each(dft, keep=True)


def _twiddle(t_local: int, n: int, k1: int, sign: float, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    # The phase index n2*k1 is formed and reduced mod n in integers, then
    # scaled by 2 pi / n in float32, as the JAX package does: an angle
    # accumulated in float32 instead goes wrong past ~1M samples.
    m = torch.remainder(torch.arange(t_local, device=device) * k1, n)
    ang = (sign * 2.0 * np.pi / n) * m.to(torch.float32)
    return torch.complex(torch.cos(ang), torch.sin(ang)).to(dtype)


def fft_sharded(x, mesh: Mesh, channel_axis: str = "channel",
                block_axis: str = "block") -> ShardedTensor:
    """Global forward FFT of a block-sharded (channels, n) signal, complex64
    in the cyclic layout: element k2 of shard k1 is X[k1 + n_blocks*k2]
    (``cyclic_freq_indices``); ``ifft_sharded`` returns to the natural
    layout."""
    xs = shard(x, mesh, -1, channel_axis, block_axis)
    n = xs.shape[-1]

    def run(row):
        a = _block_dft(Row([xb.to(torch.complex64) for xb in row],
                           row.owners), -1.0)
        return Row(a, row.owners).each(
            lambda k1, ak: _fft.fft(ak * _twiddle(ak.shape[-1], n, k1, -1.0,
                                                  ak.dtype, ak.device)))

    return ShardedTensor([run(xs.row(i)) for i in range(len(xs.shards))],
                         -1, xs.owners)


def ifft_sharded(spec, mesh: Mesh, channel_axis: str = "channel",
                 block_axis: str = "block") -> ShardedTensor:
    """The inverse of ``fft_sharded``: cyclic-layout spectrum -> complex
    signal in the natural block layout, scaled 1/n as ``torch.fft.ifft``."""
    ss = shard(spec, mesh, -1, channel_axis, block_axis)
    n = ss.shape[-1]
    nb = len(ss.shards[0])

    def step_cb(k1, sb):
        # step C's inverse (the local iFFT scales by 1/N2), then B's
        bk = _fft.ifft(sb)
        return bk * _twiddle(bk.shape[-1], n, k1, 1.0, bk.dtype, bk.device)

    def run(row):
        a = Row(row.each(step_cb, keep=True), row.owners)
        # and step A's, which brings the remaining 1/N1
        return Row(_block_dft(a, 1.0), row.owners).each(lambda k1, v: v / nb)

    return ShardedTensor([run(ss.row(i)) for i in range(len(ss.shards))],
                         -1, ss.owners)


def cyclic_freq_indices(t_local: int, nb: int, k1: int,
                        device=None) -> torch.Tensor:
    """The global frequency bin of each local element of shard k1 in the
    cyclic layout."""
    return k1 + nb * torch.arange(t_local, device=device)


def _spectral_map(spec: ShardedTensor, fn) -> ShardedTensor:
    """fn(shard, k1) on every shard of this process of a cyclic-layout
    spectrum."""
    return ShardedTensor([spec.row(i).each(lambda k1, sb: fn(sb, k1))
                          for i in range(len(spec.shards))], spec.axis,
                         spec.owners)


def hilbert_analytic_sharded(x, mesh: Mesh, channel_axis: str = "channel",
                             block_axis: str = "block") -> ShardedTensor:
    """The analytic signal of a block-sharded real signal, the function of
    ``ops.hilbert.hilbert_analytic`` (reference
    src/spectral/hilbert.c:14-75): the global FFT, the one-sided doubling
    mask at each element's global bin (no exchange), the global iFFT."""
    nb = mesh.shape[block_axis]
    n = x.shape[-1]
    half = n // 2
    spec = fft_sharded(x, mesh, channel_axis, block_axis)

    def mask(sb, k1):
        g = cyclic_freq_indices(sb.shape[-1], nb, k1, sb.device)
        if n % 2 == 0:
            factor = torch.where((g == 0) | (g == half), 1.0,
                                 torch.where(g < half, 2.0, 0.0))
        else:
            factor = torch.where(g == 0, 1.0,
                                 torch.where(g <= half, 2.0, 0.0))
        return sb * factor.to(sb.dtype)

    return ifft_sharded(_spectral_map(spec, mask), mesh, channel_axis,
                        block_axis)


def cepstrum_real_sharded(x, mesh: Mesh, channel_axis: str = "channel",
                          block_axis: str = "block") -> ShardedTensor:
    """The real cepstrum of a block-sharded signal (``ops.envelope.
    cepstrum_real``; reference src/envelope/cepstrum.c:7-39): the global
    FFT, log(|X| + 1e-12) (pointwise, layout-blind), the real part of the
    global iFFT."""
    spec = fft_sharded(x, mesh, channel_axis, block_axis)
    logmag = spec.map(lambda sb: torch.log(sb.abs() + 1e-12).to(sb.dtype))
    return ifft_sharded(logmag, mesh, channel_axis, block_axis).map(
        lambda v: v.real)
