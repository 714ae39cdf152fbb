"""The port's spectral analysis against the JAX package on the CPU, on the
same numpy input: the analytic signal, envelope and instantaneous phase
and frequency (ops/hilbert.py), the chirp-Z transform (ops/czt.py), and
the cepstrum, minimum phase and LPC (ops/envelope.py).

Tolerances, of the JAX output's max |value| unless named otherwise:
- the FFT class (Hilbert, CZT, cepstrum, minimum phase): 5e-5, the
  reference's contract (both sides float32, another FFT library);
- levinson, lpc and lpspec at order 16: 1e-4;
- the instantaneous phase, a float32 cumulative sum over the signal:
  5e-5 of its largest value; the frequency on a tone 5e-5 of the tone's;
- against float64 scipy: the JAX tests' own (tests/test_hilbert.py 1e-4
  absolute on unit-variance input, tests/test_czt.py rtol 1e-3 with atol
  2e-4 of max on the DFT contour and 2e-3 on the zoom band);
- host tables (next_fast_len, the chirps, the masks): equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

from vv_dsp_tpu.ops import czt as jczt
from vv_dsp_tpu.ops import envelope as jenv
from vv_dsp_tpu.ops import hilbert as jhil
from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import czt as tczt
from vv_dsp_tpu_torch.ops import envelope as tenv
from vv_dsp_tpu_torch.ops import hilbert as thil

FFT_TOL = 5e-5
LPC_TOL = 1e-4


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture
def sig(rng):
    return rng.standard_normal((3, 1000)).astype(np.float32)


# ---- Hilbert ----

@pytest.mark.parametrize("n", [64, 65, 1000, 1001])
def test_analytic_signal_matches_jax(rng, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    got = thil.hilbert_analytic(torch.as_tensor(x))
    assert got.dtype == torch.complex64
    assert _rel(got, jhil.hilbert_analytic(jnp.asarray(x))) < FFT_TOL
    assert _rel(thil.envelope(torch.as_tensor(x)),
                jhil.envelope(jnp.asarray(x))) < FFT_TOL


def test_analytic_signal_of_complex_input_matches_jax(rng):
    z = (rng.standard_normal((2, 257))
         + 1j * rng.standard_normal((2, 257))).astype(np.complex64)
    got = thil.hilbert_analytic(torch.as_tensor(z))
    assert _rel(got, jhil.hilbert_analytic(jnp.asarray(z))) < FFT_TOL
    assert _rel(thil.envelope(torch.as_tensor(z)),
                jhil.envelope(jnp.asarray(z))) < FFT_TOL


def test_hilbert_masks_equal_jax():
    for n in (1, 2, 7, 64, 65):
        np.testing.assert_array_equal(thil._analytic_mask(n),
                                      jhil._analytic_mask(n))
        np.testing.assert_array_equal(thil._hilbert_mult(n),
                                      jhil._hilbert_mult(n))


def test_integer_and_float64_input_follow_jax_dtypes(rng):
    xi = (rng.standard_normal((2, 128)) * 1000).astype(np.int16)
    got = thil.envelope(torch.as_tensor(xi))
    assert got.dtype == torch.float32
    assert _rel(got, jhil.envelope(jnp.asarray(xi))) < FFT_TOL
    x64 = rng.standard_normal(128)
    z = thil.hilbert_analytic(torch.as_tensor(x64))
    assert z.dtype == torch.complex128
    np.testing.assert_allclose(z.numpy(), ss.hilbert(x64), atol=1e-12)


def test_analytic_signal_scipy_parity(rng):
    """tests/test_hilbert.py's contract: 1e-4 of float64 scipy, batched."""
    for n in (64, 65):
        x = rng.standard_normal((4, n)).astype(np.float32)
        z = thil.hilbert_analytic(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(z, ss.hilbert(x.astype(np.float64)),
                                   atol=1e-4)
        np.testing.assert_allclose(z.real, x, atol=1e-3)


def test_instantaneous_phase_and_frequency_match_jax():
    """A chirp over 20,000 samples: the phase reaches ~6e3 rad, compared
    with JAX's relative to its largest value. Differenced, a float32 phase
    that large is quantized to its spacing (0.62 Hz here), and the two
    cumulative sums differ by a few of them, so the frequency is held to
    the float64 oracle (scipy's analytic signal, unwrapped): within two
    spacings, as JAX's is."""
    fs, n = 8000.0, 20000
    t = np.arange(n) / fs
    x = np.cos(2 * np.pi * (300.0 * t + 40.0 * t * t)).astype(np.float32)
    zt = thil.hilbert_analytic(torch.as_tensor(x))
    zj = jhil.hilbert_analytic(jnp.asarray(x))
    pt, pj = thil.instantaneous_phase(zt), jhil.instantaneous_phase(zj)
    assert np.abs(pt.numpy()).max() > 6e3
    assert _rel(pt, pj) < FFT_TOL
    ft = thil.instantaneous_frequency(pt, fs).numpy()
    fj = np.asarray(jhil.instantaneous_frequency(pj, fs))
    assert ft[0] == 0.0
    phase64 = np.unwrap(np.angle(ss.hilbert(x.astype(np.float64))))
    want = np.diff(phase64) * fs / (2 * np.pi)
    spacing = np.spacing(np.abs(pt.numpy()).max()) * fs / (2 * np.pi)
    inner = slice(200, -200)
    for f in (ft, fj):
        assert np.abs(f[1:][inner] - want[inner]).max() < 2 * spacing


def test_instantaneous_frequency_of_a_sine():
    """tests/test_hilbert.py: a bin-centred 50 Hz sine, mean within 0.5 Hz."""
    fs, n, f0 = 1000.0, 1000, 50.0
    x = np.sin(2 * np.pi * f0 * np.arange(n) / fs).astype(np.float32)
    phase = thil.instantaneous_phase(thil.hilbert_analytic(torch.as_tensor(x)))
    freq = thil.instantaneous_frequency(phase, fs).numpy()
    assert abs(freq[100:-100].mean() - f0) < 0.5


def test_envelope_of_am_signal():
    fs, n = 1000.0, 2048
    t = np.arange(n) / fs
    env_true = 1.0 + 0.5 * np.sin(2 * np.pi * 3.0 * t)
    x = (env_true * np.sin(2 * np.pi * 100.0 * t)).astype(np.float32)
    env = thil.envelope(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(env[200:-200], env_true[200:-200], atol=0.05)


# ---- CZT ----

def test_czt_host_tables_equal_jax():
    for target in list(range(1, 300)) + [4095, 8191, 8197, 10000]:
        assert tczt.next_fast_len(target) == jczt.next_fast_len(target)
    w, a = 0.99 * np.exp(-2j * np.pi / 37), 1.02 * np.exp(0.3j)
    for got, want in zip(tczt._czt_tables(50, 37, w, a),
                         jczt._czt_tables(50, 37, w, a)):
        np.testing.assert_array_equal(got, want)
    assert (tczt.czt_params_for_freq_range(800.0, 1200.0, 128, 8000.0)
            == jczt.czt_params_for_freq_range(800.0, 1200.0, 128, 8000.0))


@pytest.mark.parametrize("case", ["dft", "zoom", "spiral", "complex",
                                  "m_above_n"])
def test_czt_matches_jax(rng, case):
    n, m = 1000, 1000
    x = rng.standard_normal((3, n)).astype(np.float32)
    w, a = np.exp(-2j * np.pi / n), 1.0 + 0j
    if case == "zoom":
        m = 256
        w, a = tczt.czt_params_for_freq_range(800.0, 1200.0, m, 8000.0)
    elif case == "spiral":
        n, m = 200, 160
        x = x[:, :n]
        w, a = 1.001 * np.exp(-2j * np.pi / 240), 0.999 * np.exp(0.1j)
    elif case == "complex":
        x = (x + 1j * rng.standard_normal((3, n))).astype(np.complex64)
        w, a = np.exp(-2j * np.pi * 0.013), np.exp(2j * np.pi * 0.21)
    elif case == "m_above_n":
        m = 1500
    got = tczt.czt(torch.as_tensor(x), m, w, a)
    assert got.shape == (3, m) and got.dtype == torch.complex64
    assert _rel(got, jczt.czt(jnp.asarray(x), m, w, a)) < FFT_TOL


def test_czt_range_matches_jax(rng):
    x = rng.standard_normal((2, 512)).astype(np.float32)
    got = tczt.czt_range(torch.as_tensor(x), 800.0, 1200.0, 128, 8000.0)
    want = jczt.czt_range(jnp.asarray(x), 800.0, 1200.0, 128, 8000.0)
    assert _rel(got, want) < FFT_TOL


def test_czt_scipy_parity(rng):
    """tests/test_czt.py's contracts against float64 scipy."""
    n = 64
    x = rng.standard_normal(n).astype(np.float32)
    got = tczt.czt(torch.as_tensor(x), n, np.exp(-2j * np.pi / n)).numpy()
    ref = np.fft.fft(x)
    np.testing.assert_allclose(got, ref, rtol=1e-3,
                               atol=1e-3 * np.abs(ref).max())
    n, m = 50, 37
    z = (rng.standard_normal(n)
         + 1j * rng.standard_normal(n)).astype(np.complex64)
    w, a = np.exp(-2j * np.pi * 0.013), np.exp(2j * np.pi * 0.21)
    got = tczt.czt(torch.as_tensor(z), m, w, a).numpy()
    ref = ss.czt(z.astype(np.complex128), m, w, a)
    np.testing.assert_allclose(got, ref, rtol=1e-3,
                               atol=2e-4 * np.abs(ref).max())
    fs, n, m = 8000.0, 256, 128
    x = np.sin(2 * np.pi * 1000.0 * np.arange(n) / fs).astype(np.float32)
    got = tczt.czt_range(torch.as_tensor(x), 800.0, 1200.0, m, fs).numpy()
    w, a = tczt.czt_params_for_freq_range(800.0, 1200.0, m, fs)
    ref = ss.czt(x.astype(np.float64), m, w, a)
    np.testing.assert_allclose(got, ref, rtol=2e-3,
                               atol=2e-3 * np.abs(ref).max())


def test_czt_device_tables_cached(rng):
    """A second call uploads nothing: the device copies are cached."""
    x = torch.as_tensor(rng.standard_normal((2, 96)).astype(np.float32))
    tczt._tables_on.cache_clear()
    tczt.czt(x, 40, np.exp(-2j * np.pi / 96))
    tczt.czt(x, 40, np.exp(-2j * np.pi / 96))
    info = tczt._tables_on.cache_info()
    assert (info.misses, info.hits) == (1, 1)


# ---- cepstrum, minimum phase, LPC ----

@pytest.mark.parametrize("n", [512, 1000, 1001])
def test_cepstrum_matches_jax(rng, n):
    x = rng.standard_normal((3, n)).astype(np.float32)
    c = tenv.cepstrum_real(torch.as_tensor(x))
    cj = jenv.cepstrum_real(jnp.asarray(x))
    assert c.dtype == torch.float32
    assert _rel(c, cj) < FFT_TOL
    z = (x + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    assert _rel(tenv.cepstrum_real(torch.as_tensor(z)),
                jenv.cepstrum_real(jnp.asarray(z))) < FFT_TOL


@pytest.mark.parametrize("full_complex", [False, True])
def test_minimum_phase_matches_jax(rng, full_complex):
    x = rng.standard_normal((2, 512)).astype(np.float32)
    c = jenv.cepstrum_real(jnp.asarray(x))
    ct = torch.tensor(np.asarray(c))
    spec = tenv.minphase_spectrum_from_cepstrum(ct, full_complex)
    assert spec.dtype == torch.complex64
    assert _rel(spec, jenv.minphase_spectrum_from_cepstrum(
        c, full_complex)) < FFT_TOL
    assert _rel(tenv.icepstrum_minphase(ct, full_complex),
                jenv.icepstrum_minphase(c, full_complex)) < FFT_TOL
    if not full_complex:   # the reference's zero-phase envelope
        assert np.abs(spec.imag.numpy()).max() == 0.0


def test_cepstrum_float64_oracle(rng):
    x = rng.standard_normal((2, 777))
    want = np.fft.ifft(np.log(np.abs(np.fft.fft(x)) + 1e-12)).real
    got = tenv.cepstrum_real(torch.as_tensor(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


def test_lpc_matches_jax(sig):
    a, err = tenv.lpc(torch.as_tensor(sig), 16)
    aj, errj = jenv.lpc(jnp.asarray(sig), 16)
    assert a.shape == (3, 17) and err.shape == (3,)
    assert (a[..., 0] == 1).all()
    assert _rel(a, aj) < LPC_TOL
    assert _rel(err, errj) < LPC_TOL
    assert _rel(tenv.autocorr(torch.as_tensor(sig), 16),
                jenv.autocorr(jnp.asarray(sig), 16)) < FFT_TOL
    for nfft in (64, 512):
        got = tenv.lpspec(a, err, nfft)
        assert _rel(got, jenv.lpspec(aj, errj, nfft)) < LPC_TOL


def test_levinson_matches_jax_on_given_autocorrelation(rng):
    """A known AR(4) process: levinson of its autocorrelation at order 16
    against JAX's, and in float64 against a float64 numpy recursion."""
    x = ss.lfilter([1.0], [1.0, -0.9, 0.5, -0.2, 0.1],
                   rng.standard_normal((2, 4000)))
    r = np.stack([np.correlate(c, c, "full")[len(c) - 1:len(c) + 16]
                  for c in x])
    a, err = tenv.levinson(torch.as_tensor(r.astype(np.float32)), 16)
    aj, errj = jenv.levinson(jnp.asarray(r.astype(np.float32)), 16)
    assert _rel(a, aj) < LPC_TOL and _rel(err, errj) < LPC_TOL
    a64, err64 = tenv.levinson(torch.as_tensor(r), 16)
    want = np.zeros((2, 17))
    for c in range(2):
        aa, e = np.zeros(17), r[c, 0]
        aa[0] = 1.0
        for m in range(1, 17):
            k = -(r[c, m] + aa[1:m] @ r[c, m - 1:0:-1]) / e
            aa[1:m] = aa[1:m] + k * aa[m - 1:0:-1]
            aa[m] = k
            e *= 1.0 - k * k
        want[c] = aa
    np.testing.assert_allclose(a64.numpy(), want, atol=1e-12)
    np.testing.assert_allclose(a64.numpy()[:, 1:5], [[-0.9, 0.5, -0.2, 0.1]]
                               * 2, atol=0.05)


def test_levinson_zeroes_silent_input():
    """r[0] == 0: the reflection coefficients are zeroed, as in JAX."""
    a, err = tenv.lpc(torch.zeros(2, 64), 8)
    aj, errj = jenv.lpc(jnp.zeros((2, 64)), 8)
    np.testing.assert_array_equal(a.numpy(), np.asarray(aj))
    np.testing.assert_array_equal(err.numpy(), np.asarray(errj))
    assert torch.isfinite(tenv.lpspec(a, err, 32)).all()


def test_lpspec_runs_at_the_knobs_tier(sig):
    """lpspec's contractions take the matmul-precision knob's tier: at
    "high" (bf16x3) within 1e-5 of the f32 result, at "default" (bf16)
    visibly coarser but within 1e-2."""
    a, err = tenv.lpc(torch.as_tensor(sig), 16)
    f32 = tenv.lpspec(a, err, 256)
    with config.matmul_precision("high"):
        high = tenv.lpspec(a, err, 256)
    with config.matmul_precision("default"):
        low = tenv.lpspec(a, err, 256)
    assert _rel(high, f32) < 1e-5
    assert 1e-5 < _rel(low, f32) < 1e-2
