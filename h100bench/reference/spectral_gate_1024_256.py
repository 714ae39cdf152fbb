"""Plain float64 reference of the ``spectral_gate_1024_256`` configuration:
the upstream's end-to-end pipeline (vv-dsp ``bench/bench_pipeline.c``),
frame -> window -> FFT -> spectral gate -> IFFT -> overlap-add, on the
configuration's tone probe. Imports numpy, torch and the reference's own
``common`` only.

``call`` takes the pool's raw rows of N(0, 1) noise and does, in order:
builds the probe (``probe``), pads nfft - hop zeros at both ends, frames
the padded row (non-centred, the last frame zero-padded) and applies the
symmetric window, takes the rFFT, zeroes each bin whose power is below
t^2 times the largest power of its frame, takes the inverse rFFT, windows
and overlap-adds, divides by the w^2 overlap-add norm (values <= 1e-12
replaced by 1) and crops back to the row's length.

Departures from ``bench_pipeline.c``, each the port's (and the JAX
package's) own:

- the upstream runs one channel; the configuration runs rows in a batch,
  each gated on its own;
- the upstream passes NULL for the overlap-add norm (lines 140-144); this
  divides by the guarded w^2 norm, so that an ungated row comes back as
  it went in;
- the upstream frames the raw signal; this pads nfft - hop zeros at both
  ends first, so that every sample of the row has full window cover;
- the upstream's input is its own test signal; this gates the probe.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference import common as C

# err_of_scale: max |got - want| / max |want| over every sample of an
# answer. On an H100 the program read 2.71e-7 to 3.13e-7 over 12 seeds and
# the bf16 control 5.14e-3 to 5.21e-3 over 3, so the limit sits 320x above
# the one and 51x below the other; the probe's noise floor let through
# (the gate at t = 0) reads about 1.9e-3 (PERF.md).
LIMITS = {"call": {"err_of_scale": 1e-4}}

# The pipeline is float32 arithmetic outside the tensor cores, and the
# program has no lower-precision path of its own: the control is this
# pipeline with the windowed frames, the gated bins and both DFT bases
# rounded to bf16, the products summed in float32.
CONTROL = {"call": {"kind": "reference"}}


def probe(fields: dict, x: torch.Tensor) -> torch.Tensor:
    """(c, n) rows of N(0, 1) noise -> (c, n) float32 probe rows, worked out
    in float64 and rounded once:

        g env(m) (sum_j a_j cos(2 pi k_j m / nfft + phi_j) + e noise(m)),

    tones on the bin centres k_j (``probe_bins``) with amplitudes
    ``probe_amplitudes`` and phases ``probe_phases``, e = ``probe_noise``,
    env a raised-cosine fade of ``probe_fade`` samples at each end, and
    g = 2^clip(noise(0), -2, 2) the row's own gain. The gate is
    scale-invariant, so the rows share one mask and differ by O(1) in
    scale: an answer with its rows mixed is far off. Elementwise, so any
    block of rows gives the same samples bit for bit."""
    nfft = fields["nfft"]
    n = x.shape[-1]
    dev = x.device
    m = torch.arange(n, dtype=torch.int64, device=dev)
    tones = torch.zeros(n, dtype=torch.float64, device=dev)
    for k, a, phi in zip(fields["probe_bins"], fields["probe_amplitudes"],
                         fields["probe_phases"]):
        # k m reduced mod nfft first: the angle stays exact at any m
        tones += a * torch.cos(((k * m) % nfft).double()
                               * (2.0 * math.pi / nfft) + phi)
    ramp = (torch.minimum(m, n - 1 - m).double()
            / fields["probe_fade"]).clamp(max=1.0)
    env = 0.5 - 0.5 * torch.cos(math.pi * ramp)
    gain = torch.exp2(x[..., :1].double().clamp(-2.0, 2.0))
    out = x.double()
    out.mul_(fields["probe_noise"]).add_(tones).mul_(env).mul_(gain)
    return out.float()


def _geometry(fields: dict, n: int):
    """(nfft, hop, edge pad, padded length, frames)."""
    nfft, hop = fields["nfft"], fields["hop"]
    if nfft % hop:
        raise ValueError("the reference's overlap-add needs hop | nfft")
    pad = nfft - hop
    n_pad = n + 2 * pad
    return nfft, hop, pad, n_pad, C.num_frames(n_pad, nfft, hop)


def _windowed_frames(fields: dict, x: torch.Tensor, dtype):
    """The probe of raw rows x, edge-padded, framed and windowed in dtype:
    ((c, frames, nfft), window, geometry)."""
    geo = _geometry(fields, x.shape[-1])
    nfft, hop, pad, _, nf = geo
    xp = F.pad(probe(fields, x).to(dtype), (pad, pad))
    win = torch.as_tensor(C.window(fields["window"], nfft), device=x.device,
                          dtype=dtype)
    return C.frames(xp, nfft, hop, nf) * win, win, geo


def _kept(power: torch.Tensor, threshold: float) -> torch.Tensor:
    """The gate's mask: power at least t^2 times its frame's largest."""
    return power >= threshold ** 2 * power.amax(dim=-1, keepdim=True)


def overlap_add(fr: torch.Tensor, hop: int, n_out: int) -> torch.Tensor:
    """(..., frames, nfft) -> (..., n_out): frame f added at f hop, hop |
    nfft, cut (or zero-extended) to n_out."""
    *lead, nf, nfft = fr.shape
    q = nfft // hop
    acc = fr.new_zeros((*lead, nf + q - 1, hop))
    parts = fr.reshape(*lead, nf, q, hop)
    for r in range(q):
        acc[..., r:r + nf, :] += parts[..., r, :]
    flat = acc.reshape(*lead, -1)
    if flat.shape[-1] < n_out:
        flat = F.pad(flat, (0, n_out - flat.shape[-1]))
    return flat[..., :n_out]


def _synthesis(time: torch.Tensor, win: torch.Tensor, geo, n: int):
    """Inverse frames -> the cropped rows: window, overlap-add, divide by
    the guarded w^2 norm, crop the edge pad."""
    nfft, hop, pad, n_pad, nf = geo
    y = overlap_add(time * win, hop, n_pad)
    norm = overlap_add((win * win).expand(nf, nfft), hop, n_pad)
    norm = torch.where(norm > 1e-12, norm, torch.ones_like(norm))
    return (y / norm)[..., pad:pad + n]


def call(fields: dict, x: torch.Tensor) -> torch.Tensor:
    """(c, n) raw noise rows -> (c, n) float64 gated probe rows."""
    fr, win, geo = _windowed_frames(fields, x, torch.float64)
    spec = torch.fft.rfft(fr)
    power = spec.real.square() + spec.imag.square()
    spec = torch.where(_kept(power, fields["threshold"]), spec,
                       torch.zeros_like(spec))
    return _synthesis(torch.fft.irfft(spec, geo[0]), win, geo, x.shape[-1])


def gate_margin(fields: dict, x: torch.Tensor) -> torch.Tensor:
    """(c, n) raw noise rows -> (c, frames) float64: in each frame of the
    probe, the smallest factor by which any bin's power lies from the
    threshold, on whichever side it falls (a bin of zero power counts as
    infinitely far, and so does every bin of a frame of zeros, such as one
    wholly in the edge pad)."""
    fr, _, _ = _windowed_frames(fields, x, torch.float64)
    spec = torch.fft.rfft(fr)
    power = spec.real.square() + spec.imag.square()
    peak = power.amax(dim=-1, keepdim=True)
    ratio = power / (fields["threshold"] ** 2 * peak)
    margin = torch.maximum(ratio, 1.0 / ratio).amin(dim=-1)
    return torch.where(peak[..., 0] > 0, margin,
                       torch.full_like(margin, math.inf))


def control_call(fields: dict, x: torch.Tensor) -> torch.Tensor:
    """The same pipeline at bf16: the windowed frames and the real DFT's
    bases rounded to bf16, products summed in float32, the gate in float32,
    the gated bins and the inverse DFT's bases rounded to bf16, window,
    overlap-add and norm in float32."""
    fr, win, geo = _windowed_frames(fields, x, torch.float32)
    nfft = geo[0]
    dev = x.device
    k = np.arange(nfft // 2 + 1)
    ang = 2.0 * np.pi * np.outer(np.arange(nfft), k) / nfft
    bf = lambda a: torch.as_tensor(a, device=dev).to(torch.bfloat16)
    fr = fr.to(torch.bfloat16)
    re = (fr @ bf(np.cos(ang))).float()
    im = (fr @ bf(-np.sin(ang))).float()
    keep = _kept(re.square() + im.square(), fields["threshold"])
    re = torch.where(keep, re, torch.zeros_like(re))
    im = torch.where(keep, im, torch.zeros_like(im))
    # irfft as real products: the DC and Nyquist bins once, the rest twice
    w = np.where((k == 0) | (k == nfft // 2), 1.0, 2.0)[:, None] / nfft
    time = ((re.to(torch.bfloat16) @ bf(w * np.cos(ang.T))).float()
            + (im.to(torch.bfloat16) @ bf(-w * np.sin(ang.T))).float())
    return _synthesis(time, win, geo, x.shape[-1])
