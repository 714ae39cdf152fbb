"""The port's full-nfft STFT route against the JAX package on the CPU: the
power spectrogram, the complex spectrum, mel energies and MFCCs, and the
fused SpectralGate at the geometries the JAX package sends to its unpacked
("Stockham") kernels, nfft = 128 and hop = 8. The port runs its kernels'
plain versions; the JAX Pallas kernels run in interpret mode.

Tolerances, as fractions of the JAX output's max |value| unless named
otherwise (tests/test_pallas_fft.py's pins for these kernels):
- power and spectrum: 3e-6;
- mel energies: 5e-6;
- MFCC: 5e-4 absolute, at every tier the caller names (the JAX full-nfft
  kernel runs float32 whatever the tier; a bf16 projection misses by more);
- SpectralGate: 5e-6 on the retained samples [pad, pad + n), on inputs
  where a float64 oracle puts no bin within 1e-4 (relative) of the
  threshold, so no bin can flip between the two FFTs' roundings.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vv_dsp_tpu.ops import mel as jmel
from vv_dsp_tpu.ops import pallas_fft as jpf
from vv_dsp_tpu.ops.dct import _dct2_matrix
from vv_dsp_tpu.ops.window import get_window_np
from vv_dsp_tpu_torch import convert
from vv_dsp_tpu_torch.models import MFCCFrontend, SpectralGate
from vv_dsp_tpu_torch.ops import istft_kernels as tik
from vv_dsp_tpu_torch.ops import mel as tmel
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops import stockham_kernels as tstk
from vv_dsp_tpu_torch.ops.stft import STFT


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("nfft,hop,n,channels", [
    (128, 32, 3000, 2), (128, 128, 2000, 2), (128, 32, 100, 1),
    (512, 8, 2500, 2), (1024, 8, 1500, 1)])
def test_power_matches_stockham_power(rng, nfft, hop, n, channels):
    """hop == nfft, n < nfft (one frame), hop 8, q = 128 (1024/8), one
    channel."""
    x = rng.standard_normal((channels, n)).astype(np.float32)
    want = jpf.stft_power_stockham(jnp.asarray(x), nfft, hop)
    got = STFT(nfft, hop).power(torch.as_tensor(x))
    assert got.shape == want.shape == (channels,
                                       1 if n < nfft else
                                       1 + (n - nfft + hop) // hop,
                                       nfft // 2 + 1)
    assert _rel(got, want) < 3e-6


@pytest.mark.parametrize("rfft", [False, True])
def test_process_matches_stockham_spectrum(rng, rfft):
    nfft, hop, n = 512, 8, 2000
    x = rng.standard_normal((2, n)).astype(np.float32)
    want = jpf.stft_spectrum_stockham(jnp.asarray(x), nfft, hop,
                                      onesided=rfft)
    got = STFT(nfft, hop).process(torch.as_tensor(x), rfft=rfft)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert _rel(got, want) < 3e-6


@pytest.mark.parametrize("nfft,hop,n_mels,sr,n", [
    (128, 32, 26, 8000.0, 3000), (128, 128, 20, 8000.0, 2000),
    (256, 8, 40, 16000.0, 2500), (128, 32, 26, 8000.0, 90)])
def test_mel_energies_match_stockham_mel(rng, nfft, hop, n_mels, sr, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    want = jpf.stft_mel_energies_pallas(jnp.asarray(x), nfft, hop, n_mels,
                                        sr)
    got = tmel.mel_energies_stft(torch.as_tensor(x), nfft, hop, n_mels, sr)
    assert got.shape == want.shape
    assert _rel(got, want) < 5e-6


@pytest.mark.parametrize("nfft,hop,n_mels,n_mfcc,sr,lifter", [
    (128, 32, 26, 13, 8000.0, 0.0), (128, 128, 20, 12, 8000.0, 22.0),
    (256, 8, 26, 13, 16000.0, 22.0)])
def test_mfcc_frontend_matches_stockham_mfcc(rng, nfft, hop, n_mels, n_mfcc,
                                             sr, lifter):
    """MFCCFrontend built from the JAX package's arrays, and mfcc_stft."""
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    want = np.asarray(jpf.stft_mfcc_pallas(jnp.asarray(x), nfft, hop, n_mels,
                                           n_mfcc, sr, lifter=lifter))
    params = convert.frontend_params_from_reference(
        get_window_np("hann", nfft, None),
        jmel.mel_filterbank_np(nfft, n_mels, sr, 0.0, sr / 2, "htk"),
        _dct2_matrix(n_mels)[:n_mfcc] * jmel._lifter_np(n_mfcc,
                                                        lifter)[:, None])
    front = MFCCFrontend(nfft, hop, n_mels, n_mfcc, sr, lifter,
                         params=params, device="cpu")
    got = front(torch.as_tensor(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)
    got = tmel.mfcc_stft(torch.as_tensor(x), nfft, hop, n_mels, n_mfcc, sr,
                         lifter=lifter)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)


def test_mfcc_full_nfft_route_runs_float32_at_any_tier(rng):
    """The JAX full-nfft MFCC kernel takes no tier, so a bf16 caller gets
    float32 numbers there and here; the packed kernel's bf16 projection
    (the control) lands beyond the limit."""
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    want = np.asarray(jpf.stft_mfcc_pallas(jnp.asarray(x), 128, 32, 26, 13,
                                           8000.0, algorithm="bf16"))
    xt = torch.as_tensor(x)
    for algorithm in ("bf16", "bf16x3", "f32"):
        got = tmel.mfcc_stft(xt, 128, 32, 26, 13, 8000.0,
                             algorithm=algorithm)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)
    win, fb, _, dct = tmel._mfcc_constants(128, 26, 13, 8000.0, 0.0, 4000.0,
                                           0.0, "htk", "hann", None,
                                           torch.device("cpu"))
    control = tsk.stft_mfcc_plain(xt, 128, 32, win, fb, dct, 1e-10, "bf16")
    assert np.abs(control.numpy() - want).max() > 5e-4


def _min_threshold_distance(xp, nfft, hop, threshold):
    """Smallest |p2 - t^2 peak2| / (t^2 peak2) over every bin of xp's
    frames, in float64 (frames of zeros left out)."""
    n = xp.shape[-1]
    nf = 1 + (n - nfft + hop) // hop
    w = get_window_np("hann", nfft, None)
    xe = np.pad(xp.astype(np.float64),
                ((0, 0), (0, (nf - 1) * hop + nfft - n)))
    idx = np.arange(nf)[:, None] * hop + np.arange(nfft)[None, :]
    p2 = np.abs(np.fft.rfft(xe[:, idx] * w, axis=-1)) ** 2
    p2 = p2[p2.max(axis=-1) > 0]
    level = threshold ** 2 * p2.max(axis=-1, keepdims=True)
    return (np.abs(p2 - level) / level).min()


@pytest.mark.parametrize("nfft,hop,threshold,n,seed", [
    (128, 32, 0.1, 3000, 5), (128, 64, 0.2, 2000, 6), (256, 8, 0.1, 1000, 3)])
def test_spectral_gate_matches_fused_gate(nfft, hop, threshold, n, seed):
    """SpectralGate from the JAX package's window against stft_gate_pallas
    on the padded input, on the samples SpectralGate keeps."""
    x = np.random.default_rng(seed).standard_normal((2, n)).astype(
        np.float32)
    pad = nfft - hop
    xp = np.pad(x, ((0, 0), (pad, pad)))
    assert _min_threshold_distance(xp, nfft, hop, threshold) > 1e-4
    want = np.asarray(jpf.stft_gate_pallas(jnp.asarray(xp), nfft, hop,
                                           threshold))[:, pad:pad + n]
    params = convert.gate_params_from_reference(
        get_window_np("hann", nfft, None))
    got = SpectralGate(nfft, hop, threshold, params=params, device="cpu")(
        torch.as_tensor(x))
    assert got.shape == (2, n) and got.dtype == torch.float32
    assert _rel(got, want) < 5e-6


def test_fused_gate_threshold_zero_is_identity(rng):
    """Threshold 0 keeps every bin: a pure roundtrip on every retained
    sample (tests/test_pallas_fft.py's pin), one channel and 2-D."""
    x = rng.standard_normal((1, 5000)).astype(np.float32)
    gate = SpectralGate(128, 32, 0.0, device="cpu")
    np.testing.assert_allclose(gate(torch.as_tensor(x)).numpy(), x, rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(gate(torch.as_tensor(x[0])).numpy(), x[0],
                               rtol=0, atol=2e-5)


def test_fused_gate_plain_keeps_the_two_sided_peak_rule(rng):
    """The plain fused gate against a float64 loop of its definition:
    two-sided spectrum, gate over all nfft bins, real inverse, window,
    overlap-add, guarded norm (full length, this input far from the
    threshold)."""
    nfft, hop, n = 128, 32, 1000
    x = rng.standard_normal((1, n))
    w = get_window_np("hann", nfft, None)
    nf = 1 + (n - nfft + hop) // hop
    norm = tik.ola_norm_np(w, hop, nf, n)
    xe = np.pad(x, ((0, 0), (0, (nf - 1) * hop + nfft - n)))
    out = np.zeros((1, (nf - 1) * hop + nfft))
    for f in range(nf):
        spec = np.fft.fft(xe[:, f * hop:f * hop + nfft] * w)
        p2 = np.abs(spec) ** 2
        spec = np.where(p2 >= 0.09 * p2.max(), spec, 0)
        out[:, f * hop:f * hop + nfft] += np.fft.ifft(spec).real * w
    want = out[:, :n] / norm
    got = tstk.stft_gate_stockham_plain(
        torch.as_tensor(x), nfft, hop, torch.as_tensor(w),
        torch.as_tensor(norm, dtype=torch.float64), 0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


def test_geometry_predicates_equal_the_jax_package():
    checked = 0
    for nfft in (64, 128, 256, 512, 1000, 1024, 2048, 4096, 8192):
        for hop in (1, 8, 16, 24, 32, 64, 128, 250, 256, 512, 4096):
            assert tsk.packed_supported(nfft, hop) == \
                jpf.stft_mel_packed_supported(nfft, hop)
            assert tsk.packed_gate_supported(nfft, hop) == \
                jpf.stft_gate_packed_supported(nfft, hop)
            assert tstk.stockham_supported(nfft, hop) == \
                jpf.stft_mel_supported(nfft, hop)
            assert tstk.stockham_gate_supported(nfft, hop) == \
                jpf.stft_gate_supported(nfft, hop)
            checked += 1
    assert checked == 99
    assert tstk.takes_stockham(128, 32) and tstk.takes_stockham(256, 8)
    assert tstk.takes_stockham(1024, 8) and not tstk.takes_stockham(2048, 8)
    assert not tstk.takes_stockham(1024, 256)
    assert not tstk.takes_stockham(256, 8, min_nfft=512)
    assert tstk.takes_stockham_gate(128, 32)
    assert not tstk.takes_stockham_gate(128, 128)
    assert not tstk.takes_stockham_gate(1024, 256)


@pytest.fixture
def spies(monkeypatch):
    """Record which wrapper each entry point calls (the wrappers still run:
    on a CPU tensor, their plain versions)."""
    calls = []
    names = {tsk: ("stft_spectrum", "stft_power", "stft_mfcc"),
             tik: ("istft",),
             tstk: ("stft_spectrum_stockham", "stft_power_stockham",
                    "stft_mel_stockham", "stft_gate_stockham")}
    for mod, fns in names.items():
        for name in fns:
            def spy(*args, _f=getattr(mod, name), _name=name, **kw):
                calls.append(_name)
                return _f(*args, **kw)
            monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("nfft,hop,want", [
    (128, 32, ["stft_power_stockham", "stft_mel_stockham",
               "stft_gate_stockham", "stft_spectrum_stockham"]),
    (512, 8, ["stft_power_stockham", "stft_mel_stockham",
              "stft_gate_stockham", "stft_spectrum_stockham"]),
    (256, 8, ["stft_power_stockham", "stft_mel_stockham",
              "stft_gate_stockham", "stft_spectrum"]),
    (1024, 256, ["stft_power", "stft_mfcc", "stft_spectrum", "istft",
                 "stft_spectrum"]),
    (128, 128, ["stft_power_stockham", "stft_mel_stockham",
                "stft_spectrum_stockham"]),
    (2048, 8, ["stft_power", "stft_mfcc", "stft_spectrum", "istft",
               "stft_spectrum"])])
def test_entry_points_route_as_the_jax_package(spies, nfft, hop, want):
    """power, MFCC, SpectralGate and process, in that order: the full-nfft
    kernels where the JAX package takes them (process from nfft 512 up,
    the gate at hop < nfft), and process at nfft 128, where the JAX package
    runs XLA; the packed ones elsewhere, except SpectralGate at 128/128,
    which no kernel takes: it calls no wrapper (the "torch" route)."""
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((1, 3000)),
                        dtype=torch.float32)
    STFT(nfft, hop).power(x)
    tmel.mfcc_stft(x, nfft, hop, 20, 12, 8000.0)
    SpectralGate(nfft, hop, 0.1, device="cpu")(x)
    STFT(nfft, hop).process(x)
    assert spies == want


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4096, device="meta")
    w = torch.zeros(128, device="meta")
    with pytest.raises(ValueError):
        tstk.stft_power_stockham(x, 128, 32, w)
    with pytest.raises(ValueError):
        tstk.stft_spectrum_stockham(x, 128, 32, w)
    with pytest.raises(ValueError):
        tstk.stft_gate_stockham(x, 128, 32, w, torch.ones(4096), 0.1)
    with pytest.raises(ValueError):
        tstk.stft_mel_stockham(x, 128, 32, w, torch.zeros(20, 65),
                               torch.zeros(2, 20, dtype=torch.int32))


def test_counters_start_as_plain_integers():
    for fn in (tstk.stft_spectrum_stockham, tstk.stft_power_stockham,
               tstk.stft_mel_stockham, tstk.stft_gate_stockham):
        assert isinstance(fn.launches, int)
