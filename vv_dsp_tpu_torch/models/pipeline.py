"""The models of ``vv_dsp_tpu/models/pipeline.py`` as ``nn.Module``s:
``NorthStarChain``, ``SpectralGate`` and ``MFCCFrontend``.

Each builds its buffers (the device constants) on ``device``, the card
unless the caller passes ``device="cpu"``, and raises without a GPU rather
than building on the CPU. ``forward`` raises when the input lies on another
device than the buffers.

NorthStarChain:

1024-tap FIR -> 4/3 polyphase resample (one fused banded upfirdn, kernel 1;
with ``fused_head=False`` the staged pair ``fir_apply_best`` ->
``resample_poly_best``, two banded upfirdns at the flagship geometry)
-> 2048/512 STFT -> 80 HTK mel bands -> log -> 20 MFCCs (one fused kernel,
kernel 2). The module's buffers are the device constants: the composite
head filter's polyphase table, the window, the mel filterbank with its
band edges and the liftered DCT rows. ``chain_params`` builds them on the
host in float64; ``convert.params_from_reference`` carries the JAX
chain's arrays across.

The JAX chain hands the head's raw segment tiles to the STFT kernel on the
TPU to skip two transposes; here the head writes natural (c, n_out) order,
which is what the MFCC kernel reads, so the chain runs the two kernels
back to back (the same numbers).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

import torch.nn.functional as F

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import filter_kernels as _fk
from vv_dsp_tpu_torch.ops import fir as _fir
from vv_dsp_tpu_torch.ops import istft_kernels as _ik
from vv_dsp_tpu_torch.ops import mel as _mel
from vv_dsp_tpu_torch.ops import resample as _rs
from vv_dsp_tpu_torch.ops import stft_kernels as _sk
from vv_dsp_tpu_torch.ops import stockham_kernels as _stk
from vv_dsp_tpu_torch.ops.framing import stft_num_frames
from vv_dsp_tpu_torch.ops.upfirdn import polyphase_table_np
from vv_dsp_tpu_torch.ops.window import get_window_np
from vv_dsp_tpu_torch.parallel import halo as _halo
from vv_dsp_tpu_torch.parallel import ops as _par
from vv_dsp_tpu_torch.parallel.sharded import ShardedTensor, shard
from vv_dsp_tpu_torch.utils import profiling
from vv_dsp_tpu_torch.utils.device import build_device as _build_device
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp
from vv_dsp_tpu_torch.utils.shapes import collapse_leading


def _check_input(x: torch.Tensor, buffer: torch.Tensor, name: str) -> None:
    if x.device != buffer.device:
        raise ValueError(f"{name}: input on {x.device}, buffers on "
                         f"{buffer.device}; move one to the other")


def _buffer(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def chain_params(fir_taps: int = 1024, fir_cutoff: float = 0.45, up: int = 4,
                 down: int = 3, nfft: int = 2048, n_mels: int = 80,
                 n_mfcc: int = 20, sample_rate: float = 48000.0,
                 window: str = "hann") -> dict:
    """The chain's host constants, as numpy arrays: fir_coeffs (float32, as
    the JAX chain keeps them), the composite head filter g (float64) and
    its offset, the window, the mel filterbank at the output rate and the
    DCT-II rows (float64)."""
    fir = _fir.design_lowpass_np(fir_taps, fir_cutoff).astype(np.float32)
    gcd = math.gcd(up, down)
    g, offset = _rs._fused_fir_resample_filter(
        tuple(fir.astype(np.float64)), up // gcd, down // gcd)
    sr = sample_rate * up / down
    return {
        "fir_coeffs": fir,
        "g": g,
        "offset": offset,
        "window": get_window_np(window, nfft),
        "mel_fb": _mel.mel_filterbank_np(nfft, n_mels, float(sr), 0.0,
                                         float(sr) / 2.0, "htk"),
        "dct_lift": _mel.mfcc_dct_np(n_mels, n_mfcc, 0.0),
    }


class NorthStarChain(nn.Module):
    """1024-tap FIR -> up/down polyphase resample -> STFT -> log-mel -> MFCC.

    Same fields and defaults as the JAX chain. head_algorithm and
    stft_algorithm name the dot-algorithm tier of the banded head and of
    the mel/DCT contractions ("bf16x3" by default, as in the JAX chain;
    "f32" for full float32). fused_head=False runs the staged head,
    ``resample_poly_best(fir_apply_best(fir_coeffs, x), up, down)``, at
    the best paths' own tier ("f32"): as in the JAX chain, head_algorithm
    does not reach it. params: host constants from ``chain_params`` or
    ``convert.params_from_reference``; built from the fields when None.
    """

    def __init__(self, fir_taps: int = 1024, fir_cutoff: float = 0.45,
                 up: int = 4, down: int = 3, nfft: int = 2048, hop: int = 512,
                 n_mels: int = 80, n_mfcc: int = 20,
                 sample_rate: float = 48000.0, window: str = "hann",
                 fused_head: bool = True,
                 head_algorithm: str | None = "bf16x3",
                 stft_algorithm: str | None = "bf16x3",
                 params: dict | None = None, device="cuda"):
        super().__init__()
        device = _build_device(device)
        self.fir_taps, self.fir_cutoff = fir_taps, fir_cutoff
        self.up, self.down = up, down
        self.nfft, self.hop = nfft, hop
        self.n_mels, self.n_mfcc = n_mels, n_mfcc
        self.sample_rate, self.window_name = sample_rate, window
        self.fused_head = fused_head
        self.head_algorithm = head_algorithm
        self.stft_algorithm = stft_algorithm
        if params is None:
            params = chain_params(fir_taps, fir_cutoff, up, down, nfft, n_mels,
                                  n_mfcc, sample_rate, window)
        # host copies: the staged tail correction and the staged head's
        # route are built from the taps, the sharded STFT from the window
        self.fir_coeffs = np.asarray(params["fir_coeffs"])
        self.window_np = np.asarray(params["window"], dtype=np.float64)

        up_r = up // math.gcd(up, down)
        self.register_buffer("head_taps", _buffer(
            polyphase_table_np(params["g"], up_r), device))
        self.register_buffer("window", _buffer(params["window"], device))
        self.register_buffer("mel_fb", _buffer(params["mel_fb"], device))
        self.register_buffer("mel_bands", torch.as_tensor(
            _sk.band_edges_np(params["mel_fb"]), device=device))
        self.register_buffer("dct_lift", _buffer(params["dct_lift"], device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (channels, n) -> (channels, frames, n_mfcc). Spans (while a
        profiler runs): ``chain`` around the call, ``chain.head`` and
        ``chain.mfcc`` around its two stages, each timed on the device."""
        with profiling.span("chain"):
            x = config.as_compute(x)
            _check_input(x, self.head_taps, "NorthStarChain")
            with profiling.span("chain.head", device=x.device):
                if self.fused_head:
                    y = _rs.fir_resample_fused(self.fir_coeffs, x, self.up,
                                               self.down,
                                               algorithm=self.head_algorithm,
                                               taps=self.head_taps)
                else:
                    y = _fk.resample_poly_best(
                        _fk.fir_apply_best(self.fir_coeffs, x.float()),
                        self.up, self.down)
            with profiling.span("chain.mfcc", device=x.device):
                return _mel.mfcc_stft_with(
                    y, self.nfft, self.hop, self.window, self.mel_fb,
                    self.mel_bands, self.dct_lift, 1e-10,
                    self.stft_algorithm)

    def apply_sharded(self, x, mesh, fuse_halos: bool = True
                      ) -> ShardedTensor:
        """The chain over a (channel, block) mesh: (channels, n), a global
        tensor or a ``ShardedTensor``, -> (channels, frames, n_mfcc) with
        the frame axis sharded. The STFT of every shard runs on the
        full-nfft spectrum kernel (kernel 9) where its geometry takes it
        (2048/512 does), the mel/MFCC products on each shard's power (they
        contract the bin axis alone), in float32 whatever the tiers.

        fuse_halos=True (the default) runs the whole head from one left and
        one right exchange of the raw signal, sized from the dependency
        cone (``fused_head_plan``); each shard recomputes the ~1% of
        boundary work. Where the geometry does not divide evenly it gives
        way to the staged path, whose FIR, resampler and STFT each take
        their own halos, as the JAX chain does. As there, both heads run
        in float32 (``fir_apply_mxu`` and the polyphase gather's
        products), not at head_algorithm's tier."""
        if fuse_halos:
            try:
                key = self._fused_geometry(x.shape[-1], mesh.shape["block"])
            except ValueError:
                key = None
            if key is not None:
                return self._apply_sharded_fused(x, mesh, key)
        y = _par.fir_apply_sharded(self.fir_coeffs, x, mesh)
        y = _par.resample_poly_sharded(y, self.up, self.down, mesh)
        spec = _par.stft_shards(y, self.nfft, self.hop, self.window_np)
        return spec.map(self._mfcc_of_spectrum)

    def _mfcc_of_spectrum(self, spec: torch.Tensor) -> torch.Tensor:
        """MFCCs of one shard's one-sided spectrum: power, mel, log, the
        liftered DCT rows."""
        power = spec.abs().square()
        mel = power @ self.mel_fb.to(spec.device).T
        return torch.log(mel + 1e-10) @ self.dct_lift.to(spec.device).T

    def _fused_geometry(self, n: int, nb: int) -> tuple:
        """The key of ``fused_head_plan`` for n samples over nb block
        shards, or ValueError where the shards do not divide evenly."""
        g = math.gcd(self.up, self.down)
        up, down = self.up // g, self.down // g
        if n % (nb * down):
            raise ValueError("length must divide n_blocks * down")
        if n // nb * up // down % self.hop:
            raise ValueError("per-shard resampled length must divide hop")
        return (len(self.fir_coeffs), up, down, self.nfft, self.hop, n, nb)

    def _apply_sharded_fused(self, x, mesh, key: tuple) -> ShardedTensor:
        """One combined halo exchange for the whole head (apply_sharded):
        the FIR over the extended block, its ring-out past the signal's
        end masked, the polyphase gather, the resampled lookahead past
        the end masked, then the shard's STFT."""
        plan = fused_head_plan(*key)
        n, t, hl = plan["n"], plan["t"], plan["hl"]
        out_local, n2 = plan["out_local"], plan["n2"]
        h = np.asarray(self.fir_coeffs, dtype=np.float64)
        xs = shard(x, mesh)

        def head(k, xb, left, right):
            ext = torch.cat([left, xb, right], dim=-1)
            # the FIR's ring-out past the global end is not part of the
            # staged semantics (the resampler zero-pads beyond n)
            yf = _zero_from(_fir.fir_apply_mxu(h, ext), n - (k * t - hl))
            idx = _par.table_on(_par.resample_index, plan["gather"],
                                torch.int64, xb.device)
            y2 = torch.einsum(
                "...ot,ot->...o", yf[..., idx],
                _par.table_on(_par.resample_weights, plan["gather"],
                              xb.dtype, xb.device))
            # resampled lookahead past n2 is zero in the staged path
            y2 = _zero_from(y2, n2 - k * out_local)
            window = _par.window_on(self.window_np, y2.dtype, y2.device)
            return _par.stft_local(y2, self.nfft, self.hop, window,
                                   plan["nf_local"])

        spec = ShardedTensor(
            [row.each(head, _halo.halo_from_left(row, hl),
                      _halo.halo_from_right(row, plan["hr"]))
             for row in map(xs.row, range(len(xs.shards)))], -2, xs.owners)
        return spec.map(self._mfcc_of_spectrum)


@functools.lru_cache(maxsize=16)
def fused_head_plan(fir_taps: int, up: int, down: int, nfft: int, hop: int,
                    n: int, nb: int) -> dict:
    """The fused sharded head's halos and the key of its polyphase gather
    over the FIR-extended block (``parallel.ops._resample_plan`` with the
    whole extended output count and the head's left halo; up/down
    reduced). Dependency cone: a local STFT
    frame needs nfft - hop resampled samples of lookahead; resampled
    output j reads FIR output (half_len + j*down)//up - i for the taps_pp
    polyphase taps; the FIR is causal with fir_taps - 1 of history. The
    anchors are the same on every shard because t_local*up is a multiple
    of down*up (as in ``resample_poly_sharded``)."""
    t = n // nb
    out_local = t * up // down
    half_len, hpp = _par.resample_geometry(up, down)
    taps_pp = hpp.shape[1]
    ext_out = out_local + nfft - hop
    # deep halos from the dependency cone, one sample of margin each
    hl = fir_taps - 1 + max(0, taps_pp - 1 - half_len // up) + 1
    hr = max(0, (half_len + (ext_out - 1) * down) // up - (t - 1)) + 1
    return {"n": n, "t": t, "out_local": out_local, "n2": n * up // down,
            "hl": hl, "hr": hr, "gather": (up, down, ext_out, hl),
            "nf_local": out_local // hop}


def _zero_from(y: torch.Tensor, m: int) -> torch.Tensor:
    """y with positions m onward along the last axis zeroed."""
    m = max(m, 0)
    if m >= y.shape[-1]:
        return y
    return F.pad(y[..., :m], (0, y.shape[-1] - m))


def gate_route(nfft: int, hop: int) -> str:
    """SpectralGate's route: "full_nfft" (the fused full-nfft gate
    kernel), "split" (the packed spectrum kernel, then the inverse kernel
    with the gate) or "torch"."""
    if _stk.takes_stockham_gate(nfft, hop):
        return "full_nfft"
    return "split" if _ik.istft_supported(nfft, hop) else "torch"


class SpectralGate(nn.Module):
    """The reference's end-to-end benchmark pipeline: frame -> window ->
    FFT -> spectral magnitude gate -> IFFT -> OLA
    (bench/bench_pipeline.c:77-120). Every bin whose power is below
    threshold^2 times its frame's peak power is zeroed.

    The input is zero-padded by nfft - hop at both ends, so that every
    sample of the signal has full window coverage (at the edges the w^2
    norm goes to 0, and dividing a gated frame by it would amplify the
    error without bound), and the output is cut back to the input's
    length; the spectrum kernel reads that pad in place, and only the
    full-nfft route pads a copy. The route is ``gate_route``'s: on a CUDA
    tensor the spectrum kernel (one-sided) and then the inverse kernel
    with the gate; where
    the JAX package takes its fused full-nfft gate kernel
    (``stockham_kernels.takes_stockham_gate``: nfft = 128, or hop = 8) the
    one fused gate kernel, whose peak and mask cover all nfft bins of the
    two-sided spectrum, as there; where neither kernel takes the geometry
    (128/128, 128/24, a hop not dividing nfft), the plain version on any
    device, as the JAX package runs XLA there. params: ``{"window":
    float64 (nfft,)}``, e.g. ``convert.gate_params_from_reference``; the
    named window when None.
    """

    def __init__(self, nfft: int = 1024, hop: int = 256,
                 threshold: float = 0.1, window: str = "hann",
                 params: dict | None = None, device="cuda"):
        super().__init__()
        if not 0 < hop <= nfft:
            raise ValueError("need 0 < hop <= nfft")
        device = _build_device(device)
        self.nfft, self.hop, self.threshold = nfft, hop, threshold
        self.window_name = window
        if params is None:
            params = {"window": get_window_np(window, nfft)}
        # host copy in float64: the w^2 norm is built from it per length
        self.window_np = np.asarray(params["window"], dtype=np.float64)
        if self.window_np.shape != (nfft,):
            raise ValueError(f"window must have shape ({nfft},)")
        self.register_buffer("window", _buffer(self.window_np, device))

    @property
    def edge_pad(self) -> int:
        return self.nfft - self.hop

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n) -> (..., n) gated. Spans (while a profiler runs):
        ``gate`` around a call of (channels, n); inside it on the split
        route ``gate.analysis`` around the spectrum and ``gate.synthesis``
        around the gated inverse, on the full-nfft route ``gate.fused``
        around the one kernel, each timed on the device. Each call counts
        its route in ``SpectralGate.route_calls``."""
        x = config.as_compute(x)
        if x.is_complex():
            raise TypeError("SpectralGate requires real input")
        restore = None
        if x.ndim != 2:
            x, restore = collapse_leading(x)
        with profiling.span("gate"):
            _check_input(x, self.window, "SpectralGate")
            x = x.float()
            n, pad = x.shape[-1], self.edge_pad
            n_pad = n + 2 * pad
            nfft, hop = self.nfft, self.hop
            win, t = self.window, self.threshold
            norm = _ik.ola_norm(self.window_np, hop,
                                stft_num_frames(n_pad, nfft, hop), n_pad,
                                x.device)

            def fused(gate):
                def body(xv):
                    with profiling.span("gate.fused", device=xv.device):
                        return gate(xv, nfft, hop, win, norm, t)
                return body

            def split(spectrum, inverse):
                def body(xv):
                    with profiling.span("gate.analysis", device=xv.device):
                        spec = spectrum(xv, nfft, hop, win, onesided=True,
                                        pad=pad)
                    with profiling.span("gate.synthesis", device=xv.device):
                        return inverse(spec, nfft, hop, n_pad, win, norm, t)
                return body

            route = gate_route(nfft, hop)
            SpectralGate.route_calls[route] += 1
            if route == "full_nfft":
                fast = fused(_stk.stft_gate_stockham)
                plain = fused(_stk.stft_gate_stockham_plain)
                x = F.pad(x, (pad, pad))
            else:
                # the spectrum reads the edge pad in place
                fast = split(_sk.stft_spectrum, _ik.istft)
                plain = split(_sk.stft_spectrum_plain, _ik.istft_plain)
                x = x.contiguous()

            if route == "torch":
                out = plain(x)
            else:
                out = kernel_with_torch_vjp(fast, plain)(x)
            out = out[..., pad:pad + n]
            return out if restore is None else restore(out)

    def _gate(self, spec: torch.Tensor) -> torch.Tensor:
        """Zero every bin whose magnitude is below threshold x its frame's
        peak magnitude (the JAX gate of the sharded path)."""
        mag = spec.abs()
        peak = mag.amax(dim=-1, keepdim=True)
        return torch.where(mag >= self.threshold * peak, spec,
                           torch.zeros_like(spec))

    def apply_sharded(self, x, mesh) -> ShardedTensor:
        """The gate over a (channel, block) mesh: (channels, n) ->
        (channels, n) with the time axis sharded. The input is edge-padded
        by nfft - hop at both ends (as ``forward``) and zero-padded to
        whole hops of every shard; the frame-sharded analysis runs the
        full-nfft spectrum kernel on every shard where the geometry takes
        it (1024/256 does), then the gate per frame, the sharded
        overlap-add and the crop back to n. A ``ShardedTensor`` input is
        gathered first, a collective under several processes: every rank
        calls it."""
        if isinstance(x, ShardedTensor):
            x = x.gather()
        n, pad = x.shape[-1], self.edge_pad
        whole = mesh.shape["block"] * self.hop
        xp = F.pad(x, (pad, pad + (-(n + 2 * pad)) % whole))
        spec = _par.stft_shards(shard(xp, mesh), self.nfft, self.hop,
                                self.window_np)
        out = _par.reconstruct_shards(spec.map(self._gate), self.nfft,
                                      self.hop, self.window_np)
        return out.crop(pad, pad + n)


# calls of forward by ``gate_route``'s route, always on
SpectralGate.route_calls = dict.fromkeys(("full_nfft", "split", "torch"), 0)


def frontend_params(nfft: int = 1024, n_mels: int = 26, n_mfcc: int = 13,
                    sample_rate: float = 16000.0, lifter: float = 0.0,
                    window: str = "hann", fmin: float = 0.0,
                    fmax: float | None = None) -> dict:
    """MFCCFrontend's host constants in float64: the window, the HTK mel
    filterbank and the DCT-II rows with the lifter folded in."""
    if fmax is None:
        fmax = sample_rate / 2.0
    return {
        "window": get_window_np(window, nfft),
        "mel_fb": _mel.mel_filterbank_np(nfft, n_mels, float(sample_rate),
                                         float(fmin), float(fmax), "htk"),
        "dct_lift": _mel.mfcc_dct_np(n_mels, n_mfcc, float(lifter)),
    }


class MFCCFrontend(nn.Module):
    """Signal -> MFCC features, the tools/dump_mfcc.c chain as one model:
    STFT power -> mel filterbank -> log -> DCT-II -> lifter, in the fused
    MFCC kernel on a CUDA tensor (float32 contractions). params: host
    constants from ``frontend_params`` or
    ``convert.frontend_params_from_reference``; built from the fields when
    None.
    """

    def __init__(self, nfft: int = 1024, hop: int = 256, n_mels: int = 26,
                 n_mfcc: int = 13, sample_rate: float = 16000.0,
                 lifter: float = 0.0, window: str = "hann",
                 fmin: float = 0.0, fmax: float | None = None,
                 params: dict | None = None, device="cuda"):
        super().__init__()
        device = _build_device(device)
        self.nfft, self.hop = nfft, hop
        self.n_mels, self.n_mfcc = n_mels, n_mfcc
        self.sample_rate, self.lifter = sample_rate, lifter
        self.window_name, self.fmin, self.fmax = window, fmin, fmax
        if params is None:
            params = frontend_params(nfft, n_mels, n_mfcc, sample_rate,
                                     lifter, window, fmin, fmax)
        self.register_buffer("window", _buffer(params["window"], device))
        self.register_buffer("mel_fb", _buffer(params["mel_fb"], device))
        self.register_buffer("mel_bands", torch.as_tensor(
            _sk.band_edges_np(params["mel_fb"]), device=device))
        self.register_buffer("dct_lift", _buffer(params["dct_lift"], device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n) -> (..., frames, n_mfcc)."""
        x = config.as_compute(x)
        _check_input(x, self.window, "MFCCFrontend")
        return _mel.mfcc_stft_with(x, self.nfft, self.hop, self.window,
                                   self.mel_fb, self.mel_bands,
                                   self.dct_lift)
