"""The port's IIR (ops/iir.py) against the JAX package on the CPU, on the
same numpy input: ``iir_apply`` on both routes (the per-section scan and
the block state-space path), its route predicate, ``zi`` and
``return_state``, ``filtfilt_sos``, ``lfilter``, the designers, and the
scan against a sequential loop.

Tolerances:
- ``iir_apply``/``filtfilt_sos``/``lfilter`` against JAX: 1e-5 of max|y|
  for Butterworth, Chebyshev I and II designs of order <= 8 and cutoff
  >= 0.05, at n = 8,192 (the block path) and 1,000 (the scan). The scan
  forms JAX's combine tree and rounds each 2x2 product as XLA's CPU dot
  does, so it lands within float32 rounding of JAX's; the block path's
  GEMMs sum in another order;
- against float64 scipy: 3e-3 (the reference's contract,
  tests/test_iir.py);
- designers: 1e-12 of the JAX designers' largest coefficient;
- the scan against a sequential loop: an integer sum exactly, a float64
  biquad to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as ss
import torch

from vv_dsp_tpu.ops import iir as jiir
from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import iir as tiir

TOL = 1e-5
SCIPY_TOL = 3e-3

# state dimensions 4 and 8 on the block path (each new one costs the JAX
# side a compile in eager mode)
DESIGNS = {
    "butter4_0.2": lambda m: m.butter_sos(4, 0.2),
    "butter8_0.05": lambda m: m.butter_sos(8, 0.05),
    "butter4_0.3_highpass": lambda m: m.butter_sos(4, 0.3, "highpass"),
    "butter4_bandpass": lambda m: m.butter_sos(4, (0.1, 0.3), "bandpass"),
    "cheby1_4_0.1": lambda m: m.cheby1_sos(4, 1.0, 0.1),
    "cheby1_8_0.05": lambda m: m.cheby1_sos(8, 1.0, 0.05),
    "cheby2_4_0.05": lambda m: m.cheby2_sos(4, 40.0, 0.05),
    "cheby2_8_0.2": lambda m: m.cheby2_sos(8, 40.0, 0.2),
}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture
def sig(rng):
    return rng.standard_normal((2, 8192)).astype(np.float32)


@pytest.mark.parametrize("n", [8192, 1000])
@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_iir_apply_matches_jax(sig, design, n):
    sos = DESIGNS[design](tiir)
    x = sig[:, :n]
    got = tiir.iir_apply(sos, torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got, jiir.iir_apply(sos, jnp.asarray(x))) < TOL
    want = ss.sosfilt(sos, x.astype(np.float64))
    assert _rel(got, want) < SCIPY_TOL


def test_route_is_jax_block_path_ok():
    """The route predicate equals the JAX package's over a table of
    designs and lengths, unstable and nine-section designs among them."""
    designs = [DESIGNS[d](tiir) for d in sorted(DESIGNS)]
    designs += [tiir.butter_sos(18, 0.2),
                np.array([[1.0, 0.0, 0.0, 1.0, -1.01, 0.0]]),
                np.array([[1.0, 0.0, 0.0, 1.0, -1.0, 0.0]])]
    seen = set()
    for sos in designs:
        sos_n = tiir.normalize_sos(sos)
        for n in (1, 1000, 8191, 8192, 479232):
            ok = tiir._block_path_ok(sos_n, n)
            assert ok == jiir._block_path_ok(jiir.normalize_sos(sos), n)
            seen.add(ok)
    assert seen == {True, False}


def test_block_constants_equal_jax():
    sos_n = tiir.normalize_sos(tiir.butter_sos(6, 0.2))
    key = tuple(map(tuple, sos_n))
    for b_len in (512, 100):
        for got, want in zip(tiir._cascade_block_constants(key, b_len),
                             jiir._cascade_block_constants(key, b_len)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [8192, 8192 + 300, 1000])
def test_zi_and_return_state_match_jax(sig, rng, n):
    """Batched zi and scipy-style unbatched (n_sections, 2) zi, on both
    routes; the end state also where n is not a multiple of 512."""
    x = np.concatenate([sig, sig[:, :300]], -1)[:, :n]
    sos = tiir.butter_sos(4, 0.15)
    for zi in (rng.standard_normal((2, 2, 2)).astype(np.float32),
               rng.standard_normal((2, 2)).astype(np.float32)):
        y, s = tiir.iir_apply(sos, torch.as_tensor(x), return_state=True,
                              zi=torch.as_tensor(zi))
        yj, sj = jiir.iir_apply(sos, jnp.asarray(x), return_state=True,
                                zi=jnp.asarray(zi))
        assert s.shape == (2, 2, 2)
        assert _rel(y, yj) < TOL
        assert _rel(s, sj) < TOL
        want, zf = ss.sosfilt(sos, x.astype(np.float64),
                              zi=np.broadcast_to(zi, (2, 2, 2))
                              .transpose(1, 0, 2))
        assert _rel(y, want) < SCIPY_TOL
        assert _rel(s, zf.transpose(1, 0, 2)) < SCIPY_TOL


def test_end_state_continues_the_signal(sig):
    """Filtering in two pieces with the first's end state as the second's
    zi gives the whole signal's output (both routes, a ragged cut)."""
    sos = tiir.cheby1_sos(4, 1.0, 0.2)
    x = torch.as_tensor(np.concatenate([sig, sig], -1))
    whole = tiir.iir_apply(sos, x)
    for cut in (9000, 700):
        y1, s1 = tiir.iir_apply(sos, x[:, :cut], return_state=True)
        y2 = tiir.iir_apply(sos, x[:, cut:], zi=s1)
        assert _rel(torch.cat([y1, y2], -1), whole) < TOL


@pytest.mark.parametrize("ext", [8192, 1000])
def test_filtfilt_sos_matches_jax(sig, ext):
    """Both routes: the padded signal (ext samples) on the block path and
    on the scan."""
    for sos in (tiir.butter_sos(4, 0.2), tiir.cheby2_sos(4, 40.0, 0.1)):
        x = sig[:, :ext - 30]       # scipy's default pad, 15 a side
        got = tiir.filtfilt_sos(sos, torch.as_tensor(x))
        assert _rel(got, jiir.filtfilt_sos(sos, jnp.asarray(x))) < TOL
        want = ss.sosfiltfilt(sos, x.astype(np.float64), axis=-1)
        assert _rel(got, want) < SCIPY_TOL
    x = sig[:, :ext]
    got = tiir.filtfilt_sos(tiir.butter_sos(4, 0.3), torch.as_tensor(x),
                            padlen=0)
    want = jiir.filtfilt_sos(jiir.butter_sos(4, 0.3), jnp.asarray(x),
                             padlen=0)
    assert _rel(got, want) < TOL
    with pytest.raises(ValueError):
        tiir.filtfilt_sos(tiir.butter_sos(4, 0.2), torch.zeros(2, 15))


@pytest.mark.parametrize("b,a", [([1.0, -0.4], [1.0, -0.9]),
                                 ([0.2, 0.3, 0.1], [1.0, -0.5, 0.2]),
                                 ("butter4", None), ("delay", None)])
def test_lfilter_matches_jax(sig, b, a):
    """Order <= 2 is one biquad scan at any length (8,192 held to scipy
    only), higher orders the tf2sos cascade on either route."""
    if b == "butter4":
        b, a = ss.butter(4, 0.25)
    elif b == "delay":
        b, a = [0.0, 0.0, 0.5, 0.2], [1.0, -0.3, 0.1, 0.05, -0.02]
    for n in (8192, 1000):
        x = sig[:, :n]
        got = tiir.lfilter(b, a, torch.as_tensor(x))
        assert _rel(got, ss.lfilter(b, a, x.astype(np.float64))) < SCIPY_TOL
        if n == 1000 or len(a) > 3:
            assert _rel(got, jiir.lfilter(b, a, jnp.asarray(x))) < TOL


def test_biquad_apply_identity_and_int_input(rng):
    x = rng.standard_normal(128).astype(np.float32)
    y = tiir.biquad_apply(torch.as_tensor(x), 1.0, 0.0, 0.0, 0.0, 0.0)
    np.testing.assert_allclose(y.numpy(), x, atol=1e-6)
    xi = (rng.standard_normal((2, 1000)) * 1000).astype(np.int16)
    got = tiir.iir_apply(tiir.butter_sos(4, 0.2), torch.as_tensor(xi))
    assert got.dtype == torch.float32
    assert _rel(got, jiir.iir_apply(jiir.butter_sos(4, 0.2),
                                    jnp.asarray(xi))) < TOL


@pytest.mark.parametrize("btype,wn", [("lowpass", 0.3), ("highpass", 0.1),
                                      ("bandpass", (0.1, 0.4)),
                                      ("bandstop", (0.2, 0.3))])
@pytest.mark.parametrize("order", [1, 2, 5, 8])
def test_designers_equal_jax(order, btype, wn):
    for name, args in (("butter_sos", ()), ("cheby1_sos", (1.0,)),
                       ("cheby2_sos", (40.0,))):
        got = getattr(tiir, name)(order, *args, wn, btype)
        want = getattr(jiir, name)(order, *args, wn, btype)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        np.testing.assert_array_equal(tiir.sosfilt_zi_np(got),
                                      jiir.sosfilt_zi_np(want))


def test_tf2sos_zpk2sos_equal_jax():
    b, a = ss.cheby1(7, 0.5, 0.3)
    for got, want in zip(tiir.tf2zpk(b, a)[:3], jiir.tf2zpk(b, a)[:3]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tiir.tf2sos(b, a), jiir.tf2sos(b, a))
    np.testing.assert_array_equal(tiir.tf2sos([0, 0, 1.0], [1.0, -0.5]),
                                  jiir.tf2sos([0, 0, 1.0], [1.0, -0.5]))
    z, p, k = ss.cheby2(5, 30, 0.2, output="zpk")
    np.testing.assert_array_equal(tiir.zpk2sos(z, p, k, False),
                                  jiir.zpk2sos(z, p, k, False))
    np.testing.assert_array_equal(tiir.normalize_sos(2 * ss.butter(
        4, 0.2, output="sos")), jiir.normalize_sos(2 * ss.butter(
            4, 0.2, output="sos")))
    with pytest.raises(ValueError):
        tiir.butter_sos(4, (0.3, 0.1), "bandpass")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 1000])
def test_associative_scan_equals_sequential_loop(n):
    """The recursion against a sequential loop: a running sum of integers
    (exact), and a float64 biquad's cumulative maps against the DF2T
    recursion run sample by sample."""
    v = torch.arange(1, 2 * n + 1, dtype=torch.int64).reshape(2, n)
    (got,) = tiir.associative_scan(lambda f, g: (f[0] + g[0],), (v,), 1)
    assert torch.equal(got, torch.cumsum(v, 1))

    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n))
    b0, b1, b2, a1, a2 = 0.3, 0.2, -0.1, -0.6, 0.25
    a_cum, b_cum = tiir._biquad_cumulative(torch.as_tensor(x), b0, b1, b2,
                                           a1, a2)
    z1, z2 = np.zeros(2), np.zeros(2)
    y = np.zeros_like(x)
    for t in range(n):
        y[:, t] = b0 * x[:, t] + z1
        z1, z2 = b1 * x[:, t] - a1 * y[:, t] + z2, b2 * x[:, t] - a2 * y[:, t]
        np.testing.assert_allclose(b_cum[:, t].numpy(), np.stack([z1, z2], 1),
                                   rtol=1e-12, atol=1e-12)
    got = tiir.biquad_apply(torch.as_tensor(x), b0, b1, b2, a1, a2)
    np.testing.assert_allclose(got.numpy(), y, rtol=1e-12, atol=1e-12)
    assert a_cum.shape == (2, n, 2, 2)


def test_scan_at_lower_tiers(sig):
    """The combines take the matmul-precision knob's tier: at "high"
    (bf16x3) the scan and the block path stay within scipy's contract."""
    x = torch.as_tensor(sig)
    sos = tiir.butter_sos(4, 0.2)
    with config.matmul_precision("high"):
        for n in (8192, 1000):
            got = tiir.iir_apply(sos, x[:, :n])
            want = ss.sosfilt(sos, sig[:, :n].astype(np.float64))
            assert _rel(got, want) < SCIPY_TOL
