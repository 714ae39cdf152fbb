"""The routes of the port's entry points against the JAX package on the
CPU: each route function (``stft.spectrum_route``, ``power_route``,
``inverse_route``, ``mel.mel_route``, ``pipeline.gate_route``,
``resample.head_route``) against the JAX package's own dispatch predicates
over a table of geometries, and each call the JAX package runs on XLA
against that XLA path on the same numpy input: the port's "torch" route
(the plain version), which runs on any device.

The port takes the JAX package's kernel wherever the JAX package takes
one. Where the JAX package runs XLA, the port takes the "torch" route,
except at the geometries its kernels take beyond the JAX package's:
``STFT.process`` and ``reconstruct`` at nfft = 128 on the full-nfft
lattice, the packed forward and inverse kernels at any hop of their nfft
range, and the banded upfirdn wherever its plan finds a layout.

Tolerances, of the JAX output's max |value| unless named otherwise:
spectra, powers and mel energies 5e-5 (the FFT-class contract);
MFCCs 5e-4 absolute (the fused-MFCC pin of tests/test_pallas_fft.py); the
inverse STFT and SpectralGate 5e-6 of max(1, scale) on samples more than
nfft from either end (tests/test_pallas_fft.py's pin), the gate on inputs
whose every bin lies more than 1e-4 (relative) from the threshold in
float64; the fused head 1e-5 (the resampler limit of chip_smoke.py).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vv_dsp_tpu.models import MFCCFrontend as JaxFrontend
from vv_dsp_tpu.models import SpectralGate as JaxGate
from vv_dsp_tpu.ops import mel as jmel
from vv_dsp_tpu.ops import pallas_fft as jpf
from vv_dsp_tpu.ops import pallas_upfirdn as jpu
from vv_dsp_tpu.ops import resample as jrs
from vv_dsp_tpu.ops.stft import STFT as JaxSTFT
from vv_dsp_tpu_torch.models import MFCCFrontend, SpectralGate
from vv_dsp_tpu_torch.models import pipeline as tpipe
from vv_dsp_tpu_torch.ops import istft_kernels as tik
from vv_dsp_tpu_torch.ops import mel as tmel
from vv_dsp_tpu_torch.ops import mma_plan as mp
from vv_dsp_tpu_torch.ops import resample as trs
from vv_dsp_tpu_torch.ops import stft as tstft
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops import stockham_kernels as tstk
from vv_dsp_tpu_torch.ops.stft import STFT
from test_torch_synthesis import _min_threshold_distance

NFFTS = (64, 100, 128, 256, 512, 1000, 1024, 2048, 4096, 8192)
HOPS = (8, 16, 24, 32, 64, 128, 250, 256, 384, 512, 1024)
GEOMETRIES = [(nfft, hop) for nfft, hop in itertools.product(
    NFFTS, HOPS + (None,)) if hop is None or hop <= nfft]
GEOMETRIES = [(nfft, hop or nfft) for nfft, hop in GEOMETRIES]


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _expect(jax_route: str, extension: str | None) -> str:
    """The port's route: the JAX package's kernel where it takes one, else
    the port's own kernel where it reaches further, else "torch"."""
    if jax_route != "xla":
        return jax_route
    return extension or "torch"


def test_routes_follow_the_jax_predicates():
    packed, full = jpf.stft_mel_packed_supported, jpf.stft_mel_supported
    for nfft, hop in GEOMETRIES:
        g = (nfft, hop)
        jax_spectrum = ("packed" if nfft >= 256 and packed(*g) else
                        "full_nfft" if nfft >= 512 and full(*g) else "xla")
        ext = ("full_nfft" if tstk.takes_stockham_128(*g) else
               "packed" if tsk.stft_supported(*g) else None)
        assert tstft.spectrum_route(*g, False) == _expect(jax_spectrum,
                                                           ext), g
        jax_power = ("packed" if packed(*g) else
                     "full_nfft" if full(*g) else "xla")
        ext = "packed" if tsk.stft_supported(*g) else None
        assert tstft.power_route(*g, False) == _expect(jax_power, ext), g
        assert tmel.mel_route(*g) == _expect(jax_power, ext), g
        jax_inverse = ("packed" if nfft >= 256 and packed(*g) else
                       "full_nfft" if nfft >= 2048 and full(*g) else "xla")
        ext = ("full_nfft" if tstk.takes_stockham_128(*g) else
               "packed" if tik.istft_supported(*g) else None)
        assert tstft.inverse_route(*g) == _expect(jax_inverse, ext), g
        jax_gate = ("split" if jpf.stft_gate_packed_supported(*g) else
                    "full_nfft" if jpf.stft_gate_supported(*g) else "xla")
        ext = "split" if tik.istft_supported(*g) else None
        assert tpipe.gate_route(*g) == _expect(jax_gate, ext), g
        assert tstft.spectrum_route(*g, True) == "torch"
        assert tstft.power_route(*g, True) == "torch"


@pytest.mark.parametrize("taps,up,down", [(1024, 4, 3), (64, 160, 147),
                                          (1024, 8, 7), (16, 1, 1000)])
def test_head_route_follows_the_plan(taps, up, down, monkeypatch):
    """The fused head takes the banded kernel wherever the JAX package's
    banded kernel does, and further, wherever the plan finds a layout;
    "torch" where it finds none (a shared-memory budget of 1 KiB, below
    the least layout's 1,296 bytes: a Hankel window of stride 8 at the
    bf16 tier)."""
    h = np.hanning(taps)
    g, off = trs._fused_fir_resample_filter(tuple(h), up, down)
    taps_pp = -(-len(g) // up)
    if jpu.banded_supported(up, down, len(g), off):
        assert trs.head_route(up, down, taps_pp, off, None) == "banded"
    for algorithm in ("f32", "bf16x3", "bf16"):
        assert trs.head_route(up, down, taps_pp, off, algorithm) == "banded"
        fits = mp.upfirdn_fits(up, down, taps_pp, off, algorithm)
        mp.upfirdn_plan(up, down, taps_pp, off, algorithm)
        assert fits
    mp._upfirdn_search.cache_clear()
    monkeypatch.setattr(mp, "SMEM_BYTES", 1024)
    try:
        assert trs.head_route(up, down, taps_pp, off, "f32") == "torch"
        with pytest.raises(ValueError):
            mp.upfirdn_plan(up, down, taps_pp, off, "f32")
    finally:
        mp._upfirdn_search.cache_clear()


@pytest.fixture
def sig(rng):
    return rng.standard_normal((2, 5000)).astype(np.float32)


@pytest.mark.parametrize("nfft,hop", [(1000, 250), (64, 16), (8192, 2048)])
def test_forward_routes_match_the_xla_path(sig, nfft, hop):
    plan, jplan = STFT(nfft, hop), JaxSTFT(nfft, hop)
    tx, jx = torch.as_tensor(sig), jnp.asarray(sig)
    assert tstft.spectrum_route(nfft, hop, False) == "torch"
    for rfft in (False, True):
        want = jplan._process_xla(jx, rfft)
        assert _rel(torch.view_as_real(plan.process(tx, rfft)),
                    np.stack([np.real(want), np.imag(want)], -1)) < 5e-5
    assert _rel(plan.power(tx), jplan.power(jx)) < 5e-5
    assert _rel(plan.spectrogram(tx), jplan.spectrogram(jx)) < 5e-5


def test_complex_input_matches_the_xla_path(sig):
    z = (sig[0] + 1j * sig[1]).astype(np.complex64)
    got = STFT(1024, 256).process(torch.as_tensor(z))
    want = JaxSTFT(1024, 256).process(jnp.asarray(z))
    assert _rel(torch.view_as_real(got),
                np.stack([np.real(want), np.imag(want)], -1)) < 5e-5
    with pytest.raises(TypeError):
        STFT(1024, 256).power(torch.as_tensor(z))


def test_reconstruct_off_the_lattice_matches_the_xla_path(sig):
    """1024/384: hop does not divide nfft. rfft=True and a Hermitian
    two-sided spectrum (rfft=False, where the port reads bins 0..512 and
    the JAX XLA path inverts all 1024) give the XLA path's result; the
    port's overlap-add is the same sum of dense adds on every device."""
    nfft, hop = 1024, 384
    assert tstft.inverse_route(nfft, hop) == "torch"
    jplan, plan = JaxSTFT(nfft, hop), STFT(nfft, hop)
    n = sig.shape[-1]
    e = nfft
    for rfft in (True, False):
        spec = np.asarray(jplan.process(jnp.asarray(sig), rfft=rfft))
        want = np.asarray(jplan.reconstruct(jnp.asarray(spec), n, rfft=rfft))
        got = plan.reconstruct(torch.as_tensor(spec), n, rfft=rfft).numpy()
        scale = max(1.0, np.abs(want).max())
        assert np.abs(got - want)[:, e:-e].max() / scale < 5e-6
        np.testing.assert_allclose(got[:, e:-e], sig[:, e:-e], atol=3e-5)


@pytest.mark.parametrize("nfft,hop,seed", [(128, 24, 5), (128, 128, 1),
                                           (1000, 250, 1)])
def test_spectral_gate_routes_match_the_xla_path(nfft, hop, seed):
    assert tpipe.gate_route(nfft, hop) == "torch"
    x = np.random.default_rng(seed).standard_normal((2, 3000)).astype(
        np.float32)
    pad = nfft - hop
    assert _min_threshold_distance(np.pad(x, ((0, 0), (pad, pad))), nfft,
                                   hop, 0.1) > 1e-4
    want = np.asarray(JaxGate(nfft, hop, 0.1)(jnp.asarray(x)))
    got = SpectralGate(nfft, hop, 0.1, device="cpu")(torch.as_tensor(x))
    assert got.shape == (2, 3000)
    e = nfft
    assert np.abs(got.numpy() - want)[:, e:-e].max() / \
        max(1.0, np.abs(want).max()) < 5e-6


@pytest.mark.parametrize("nfft,hop", [(128, 24), (1000, 250)])
def test_mel_routes_match_the_xla_path(sig, nfft, hop):
    assert tmel.mel_route(nfft, hop) == "torch"
    tx, jx = torch.as_tensor(sig), jnp.asarray(sig)
    got = tmel.mel_energies_stft(tx, nfft, hop, 20, 16000.0)
    assert _rel(got, jmel.mel_energies_stft(jx, nfft, hop, 20, 16000.0)) \
        < 5e-5
    got = tmel.mfcc_stft(tx, nfft, hop, 20, 13, 16000.0, lifter=22.0)
    want = jmel.mfcc_stft(jx, nfft, hop, 20, 13, 16000.0, lifter=22.0)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 5e-4
    got = MFCCFrontend(nfft, hop, device="cpu")(tx)
    want = JaxFrontend(nfft, hop)(jx)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 5e-4


def test_fused_head_torch_route_matches_the_xla_path(sig, monkeypatch):
    """Where the plan finds no layout (a 1 KiB budget), fir_resample_fused
    runs upfirdn_tall in the JAX package's frame group and calls no kernel
    wrapper: the JAX package's _upfirdn_tall route on the same input."""
    h = np.hanning(64) / np.hanning(64).sum()
    calls = []
    monkeypatch.setattr(trs, "upfirdn_banded",
                        lambda *a: calls.append(a) or None)
    mp._upfirdn_search.cache_clear()
    monkeypatch.setattr(mp, "SMEM_BYTES", 1024)
    try:
        got = trs.fir_resample_fused(h, torch.as_tensor(sig), 4, 3)
    finally:
        mp._upfirdn_search.cache_clear()
    want = jrs.fir_resample_fused(h, jnp.asarray(sig), 4, 3)
    assert calls == []
    assert got.shape == (2, -(-5000 * 4 // 3))
    assert _rel(got, want) < 1e-5
