"""The port's core API against the JAX package on the CPU, on the same
numpy input: framing, the config knobs (the matmul-precision knob's tier
against JAX ``pallas_kernels.dot_algorithm``), the NaN policy, the complex
helpers, the FFT extras, the DCTs, the statistics, and the package's
exports (``import vv_dsp_tpu_torch`` loads no jax and no op module).

Tolerances, of the JAX output's max |value| unless named otherwise:
- framing indices and frames, nan policy, shifts, hermitian_expand, the
  knob table: equal (the same integer maps and selections);
- overlap_add, the complex helpers, rfft_power, phase wrap and unwrap:
  1e-6 (float32, another summation order);
- DCTs: 1e-5, tighter than tests/test_dct.py's 1e-4 pins against their
  float64 oracles;
- stats: 1e-5, tighter than tests/test_stats.py's 1e-4 (skewness and
  kurtosis 1e-4 absolute there: 1e-5 here); kahan_sum 1e-6, its pin.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vv_dsp_tpu import config as jconfig
from vv_dsp_tpu.ops import complex_ops as jcx
from vv_dsp_tpu.ops import dct as jdct
from vv_dsp_tpu.ops import fft as jfft
from vv_dsp_tpu.ops import framing as jfr
from vv_dsp_tpu.ops import pallas_kernels as jpk
from vv_dsp_tpu.ops import stats as jstats
from vv_dsp_tpu.utils import nan_policy as jnan
from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.models import NorthStarChain, SpectralGate
from vv_dsp_tpu_torch.ops import complex_ops as tcx
from vv_dsp_tpu_torch.ops import dct as tdct
from vv_dsp_tpu_torch.ops import fft as tfft
from vv_dsp_tpu_torch.ops import framing as tfr
from vv_dsp_tpu_torch.ops import istft_kernels as tik
from vv_dsp_tpu_torch.ops import stats as tstats
from vv_dsp_tpu_torch.ops import upfirdn as tuf
from vv_dsp_tpu_torch.utils import nan_policy as tnan
from torch_one_thread import one_thread


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture
def sig(rng):
    return rng.standard_normal((2, 300)).astype(np.float32)


# ---- framing ----

@pytest.mark.parametrize("n,frame,hop,center", [
    (300, 64, 16, True), (300, 64, 24, False), (50, 64, 16, False),
    (1, 4, 1, True)])
def test_framing_matches_jax(rng, n, frame, hop, center):
    x = rng.standard_normal((2, n)).astype(np.float32)
    assert tfr.num_frames(n, frame, hop, center) == jfr.num_frames(
        n, frame, hop, center)
    idx, mask = tfr.frame_indices(n, frame, hop, center, device="cpu")
    jidx, jmask = jfr.frame_indices(n, frame, hop, center)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (mask is None) == (jmask is None)
    if mask is not None:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    w = np.hanning(frame).astype(np.float32)
    got = tfr.fetch_frames(torch.as_tensor(x), frame, hop, center, w)
    want = jfr.fetch_frames(jnp.asarray(x), frame, hop, center, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    i = np.arange(-3 * n, 3 * n)
    np.testing.assert_array_equal(
        tfr.symmetric_index(torch.as_tensor(i), n).numpy(),
        np.asarray(jfr.symmetric_index(jnp.asarray(i), n)))


@pytest.mark.parametrize("hop,out_len", [(16, 200), (24, 260), (7, 100),
                                         (64, 700)])
def test_overlap_add_matches_jax(rng, hop, out_len):
    frames = rng.standard_normal((2, 9, 64)).astype(np.float32)
    got = tfr.overlap_add(torch.as_tensor(frames), hop, out_len)
    want = jfr.overlap_add(jnp.asarray(frames), hop, out_len)
    assert got.shape == (2, out_len)
    assert _rel(got, want) < 1e-6


def test_overlap_add_is_differentiable():
    frames = torch.ones(2, 5, 10, dtype=torch.float64, requires_grad=True)
    tfr.overlap_add(frames, 3, 20).sum().backward()
    # every sample of a frame lands inside the 20 kept but those past it
    want = torch.ones(5, 10, dtype=torch.float64)
    for f in range(5):
        want[f, max(0, 20 - 3 * f):] = 0
    torch.testing.assert_close(frames.grad[0], want)


# ---- config ----

@pytest.mark.parametrize("name,tier", [("highest", "f32"),
                                       ("high", "bf16x3"),
                                       ("default", "bf16")])
def test_precision_knob_maps_as_the_jax_package(name, tier):
    assert config.get_matmul_precision() == "highest"
    with config.matmul_precision(name), jconfig.matmul_precision(name):
        assert config.get_matmul_precision() == name
        assert config.dot_algorithm(None) == tier
        assert config.dot_algorithm(None) == jpk.dot_algorithm(None)
        assert config.dot_algorithm("f32") == "f32"
    assert config.dot_algorithm(None) == "f32"
    with pytest.raises(ValueError):
        config.set_matmul_precision("fastest")


def test_models_keep_their_tier_under_the_knob(rng, monkeypatch):
    """The chain names its tiers (bf16x3) and the fused gate computes
    float32, so neither moves with the knob; a call naming no tier does."""
    x = torch.as_tensor(rng.standard_normal((1, 4000)), dtype=torch.float32)
    chain, gate = NorthStarChain(device="cpu"), SpectralGate(device="cpu")
    tiers = []
    banded = tuf.upfirdn_banded

    def spy(*args):
        tiers.append(args[6])
        return banded(*args)

    import vv_dsp_tpu_torch.ops.resample as trs
    monkeypatch.setattr(trs, "upfirdn_banded", spy)
    window = torch.hann_window(1024, periodic=False)
    norm = torch.ones(4000)
    with one_thread():
        base = chain(x), gate(x)
        for name in ("high", "default"):
            with config.matmul_precision(name):
                assert torch.equal(chain(x), base[0])
                assert torch.equal(gate(x), base[1])
                tik.stft_gate_packed(x, 1024, 256, 0.1, window, norm)
                with pytest.raises(ValueError):
                    tik.stft_gate_packed(x, 1024, 256, 0.1, window, norm,
                                         algorithm="bf16")
    assert tiers == ["bf16x3"] * 3


def test_dtypes_caches_and_denormals():
    assert config.complex_dtype() == torch.complex64
    assert config.complex_dtype(torch.complex128) == torch.complex128
    assert config.complex_for_real(torch.float64) == torch.complex128
    assert config.complex_for_real(torch.float32) == torch.complex64
    tdct._dct2_matrix(8)
    assert config.clear_all_caches(include_jit=True) > 10
    assert tdct._dct2_matrix.cache_info().currsize == 0
    try:
        assert config.set_flush_denormals(True, "cpu") == \
            torch.set_flush_denormal(True)
        assert config.get_flush_denormals("cuda") is False
    finally:
        assert config.set_flush_denormals(False, "cpu") is False
    # the CPU flag is off again: a denormal survives
    assert torch.tensor([1e-40]).item() != 0.0


# ---- NaN policy and complex helpers ----

@pytest.mark.parametrize("policy", list(tnan.NanPolicy))
def test_nan_policy_matches_jax(policy):
    x = np.array([1.0, np.nan, np.inf, -np.inf, -2.0], np.float32)
    got = tnan.apply_nan_policy(torch.as_tensor(x), policy)
    want = jnan.apply_nan_policy(jnp.asarray(x),
                                 jnan.NanPolicy(policy.value))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(tnan.has_nan_or_inf(torch.as_tensor(x)))
    assert not bool(tnan.has_nan_or_inf(torch.ones(3)))


def test_complex_helpers_match_jax(rng):
    a, b = ((rng.standard_normal(64) + 1j * rng.standard_normal(64))
            .astype(np.complex64) for _ in range(2))
    ta, tb, ja, jb = (torch.as_tensor(a), torch.as_tensor(b), jnp.asarray(a),
                      jnp.asarray(b))
    for name in ("cpx_add", "cpx_sub", "cpx_mul"):
        assert _rel(getattr(tcx, name)(ta, tb),
                    getattr(jcx, name)(ja, jb)) < 1e-6
    for name in ("cpx_conj", "cpx_abs", "cpx_phase"):
        assert _rel(getattr(tcx, name)(ta), getattr(jcx, name)(ja)) < 1e-6
    assert _rel(tcx.cpx(ta.real, ta.imag), a) == 0
    assert _rel(tcx.cpx_from_polar(tcx.cpx_abs(ta), tcx.cpx_phase(ta)),
                a) < 1e-6
    assert tcx.cpx(torch.arange(3), torch.arange(3)).dtype == torch.complex64
    moved = tcx.cpx_to_device(a, device="cpu")
    assert moved.dtype == torch.complex64
    np.testing.assert_array_equal(tcx.cpx_from_device(moved), a)


# ---- FFT extras ----

@pytest.mark.parametrize("n", [15, 16])
def test_fft_extras_match_jax(rng, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    assert _rel(tfft.rfft_power(tx), jfft.rfft_power(jx)) < 1e-6
    assert _rel(tfft.rfft_power(tx, 2 * n), jfft.rfft_power(jx, 2 * n)) < 1e-6
    half = tfft.rfft(tx)
    np.testing.assert_array_equal(
        tfft.hermitian_expand(half, n).numpy(),
        np.asarray(jfft.hermitian_expand(jnp.asarray(half.numpy()), n)))
    for name in ("fftshift", "ifftshift"):
        np.testing.assert_array_equal(getattr(tfft, name)(tx).numpy(),
                                      np.asarray(getattr(jfft, name)(jx)))
    ph = (np.linspace(-20, 20, 2 * n).reshape(2, n).astype(np.float32))
    ph[0, 0] = -np.pi
    assert _rel(tfft.phase_wrap(torch.as_tensor(ph)),
                jfft.phase_wrap(jnp.asarray(ph))) < 1e-6
    assert _rel(tfft.phase_unwrap(torch.as_tensor(ph)),
                jfft.phase_unwrap(jnp.asarray(ph))) < 1e-6
    assert [tfft.next_pow2(v) for v in (1, 5, 64, 65)] == \
        [jfft.next_pow2(v) for v in (1, 5, 64, 65)]


def test_fft_backend_switch():
    assert tfft.get_fft_backend() == "torch"
    assert tfft.is_backend_available("torch")
    assert not tfft.is_backend_available("matmul")
    with pytest.raises(ValueError):
        tfft.set_fft_backend("matmul")
    tfft.set_fft_backend("torch")
    tfft._dft_basis(8, "r2c")
    tfft.clear_plan_cache()
    assert tfft._dft_basis.cache_info().currsize == 0


# ---- DCT ----

@pytest.mark.parametrize("n", [7, 64, 4096])
@pytest.mark.parametrize("kind,inverse", [(2, False), (2, True), (3, False),
                                          (3, True), (4, False), (4, True)])
def test_dct_matches_jax(rng, n, kind, inverse):
    x = rng.standard_normal((2, n)).astype(np.float32)
    got = tdct.dct(torch.as_tensor(x), kind, inverse)
    want = jdct.dct(jnp.asarray(x), kind, inverse)
    assert _rel(got, want) < 1e-5


def test_dct_nan_policy_and_fft_form(rng):
    x = np.array([[1.0, np.nan, 3.0, np.inf]], np.float32)
    for policy in tnan.NanPolicy:
        got = tdct.dct(torch.as_tensor(x), nan_policy=policy)
        want = jdct.dct(jnp.asarray(x), nan_policy=jnan.NanPolicy(
            policy.value))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # the rfft form at 4096 points inverts the forward one
    y = torch.as_tensor(rng.standard_normal((1, 4096)))
    torch.testing.assert_close(tdct.dct2_backward(tdct.dct2_forward(y)), y)


# ---- stats ----

@pytest.mark.parametrize("name", [
    "sum_", "mean", "var", "minimum", "maximum", "argmin", "argmax",
    "cumsum", "diff", "rms", "crest_factor", "zero_crossing_count",
    "skewness", "kurtosis", "kahan_sum"])
def test_stats_match_jax(sig, name):
    got = getattr(tstats, name)(torch.as_tensor(sig))
    want = getattr(jstats, name)(jnp.asarray(sig))
    assert got.shape == want.shape
    assert _rel(got, want) < (1e-6 if name == "kahan_sum" else 1e-5)


def test_stats_two_argument_forms_match_jax(sig):
    tx, jx = torch.as_tensor(sig), jnp.asarray(sig)
    for got, want in zip(tstats.peak(tx), jstats.peak(jx)):
        assert _rel(got, want) == 0
    assert _rel(tstats.clamp(tx, -0.5, 0.5), jstats.clamp(jx, -0.5, 0.5)) == 0
    for biased in (False, True):
        assert _rel(tstats.autocorrelation(tx, 40, biased),
                    jstats.autocorrelation(jx, 40, biased)) < 1e-5
    assert _rel(tstats.cross_correlation(tx, tx.flip(-1) * 2, 40),
                jstats.cross_correlation(jx, jx[..., ::-1] * 2, 40)) < 1e-5
    zero = torch.zeros(1, 8)
    assert torch.isinf(tstats.crest_factor(zero)).all()
    assert (tstats.skewness(zero) == 0).all()


# ---- exports ----

# the names vv_dsp_tpu/__init__.py exports, and its lazy models,
# streaming, parallel and io
JAX_EXPORTS = (
    "config", "NanPolicy", "apply_nan_policy", "get_window", "WINDOW_NAMES",
    "window", "complex_ops", "stats", "framing", "fft", "stft", "dct", "czt",
    "hilbert", "fir", "iir", "savgol", "resample", "envelope", "mel",
    "fft_c2c", "ifft", "rfft", "irfft", "fftshift", "ifftshift",
    "phase_wrap", "phase_unwrap", "STFT", "stft_spectrogram", "num_frames",
    "fetch_frames", "overlap_add", "models", "streaming", "parallel", "io")


def test_package_exports_without_jax_or_kernels():
    """The top level re-exports the JAX package's names that the port has;
    importing it loads neither jax nor an op module (no kernel build)."""
    import vv_dsp_tpu as jpkg
    import vv_dsp_tpu_torch as tpkg
    code = ("import sys, vv_dsp_tpu_torch as v; "
            "print('jax' in sys.modules, any(m.startswith("
            "'vv_dsp_tpu_torch.ops') for m in sys.modules)); "
            "v.STFT; print('vv_dsp_tpu_torch.ops.stft' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["False", "False", "True"]
    for name in JAX_EXPORTS:
        assert hasattr(jpkg, name), name
        assert hasattr(tpkg, name), name
    assert tpkg.fft_c2c is tfft.fft and tpkg.NanPolicy is tnan.NanPolicy
    with pytest.raises(AttributeError):
        tpkg.no_such_module
