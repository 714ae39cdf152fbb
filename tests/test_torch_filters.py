"""The port's filter and resample entry points against the JAX package and
float64 scipy, on the CPU (the kernels' plain versions): the direct FIR,
the per-phase polyphase resampler, ``fir_apply_best``,
``resample_poly_best``, ``resample_multistage``, the banded route's
geometry rule, the fused head's short-signal and equal-rate branches, and
the staged ``NorthStarChain``.

The JAX kernels run in interpret mode, as tests/test_pallas.py runs them.
Tolerances, as fractions of max |y|:
- FIR: 2e-5, the JAX package's FIR tolerance (tests/test_pallas.py:22);
  the port's plain form and the JAX kernel sum the same products in
  another order (measured <= 2.2e-7 on these inputs);
- resampling: 1e-5 against the JAX functions and float64 scipy (float32
  sums of 21-41 products; measured <= 5e-7), tighter than the JAX test's
  2e-4;
- the staged chain: 5e-5 against the JAX staged chain (the port's CPU
  path keeps the bf16x3 MFCC tier, as test_torch_pipeline.py's chain test)
  and 1e-4 against the port's fused chain (tests/test_models.py's limit).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy import signal as ss

from vv_dsp_tpu.models import NorthStarChain as JaxChain
from vv_dsp_tpu.ops import fir as jfir
from vv_dsp_tpu.ops import pallas_kernels as jpk
from vv_dsp_tpu.ops import pallas_upfirdn as jpu
from vv_dsp_tpu.ops import resample as jrs
from vv_dsp_tpu_torch.models import NorthStarChain
from vv_dsp_tpu_torch.ops import filter_kernels as tfk
from vv_dsp_tpu_torch.ops import fir as tfir
from vv_dsp_tpu_torch.ops import resample as trs
from vv_dsp_tpu_torch.ops import upfirdn as tuf
from torch_one_thread import one_thread

FIR_TOL = 2e-5
RESAMPLE_TOL = 1e-5


def _rel(got, want):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    return err / np.abs(want).max()


def _lowpass(taps):
    return jfir.design_lowpass_np(taps, 0.3) if taps > 1 else np.array([0.5])


@pytest.fixture
def sig(rng):
    return rng.standard_normal((3, 3000)).astype(np.float32)


@pytest.fixture
def spy(monkeypatch):
    """Records the kernel wrappers and the matmul routes the best paths
    take, by name; each still runs."""
    calls = []

    def wrap(module, name):
        real = getattr(module, name)

        def f(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, f)

    for name in ("fir_direct", "upfirdn_banded", "fir_apply_mxu",
                 "resample_poly_mxu", "resample_poly_plain", "resample_poly"):
        wrap(tfk, name)
    return calls


@pytest.mark.parametrize("taps", [1, 7, 16, 33, 129])
def test_fir_direct_plain_matches_pallas_kernel(sig, taps):
    h = _lowpass(taps)
    want = np.asarray(jpk.fir_apply_pallas(jnp.asarray(h, jnp.float32),
                                           jnp.asarray(sig), block_t=512,
                                           interpret=True))
    x = torch.as_tensor(sig)
    got = tfk.fir_direct_plain(h, x)
    assert got.shape == (3, 3000) and got.dtype == torch.float32
    assert _rel(got, want) < FIR_TOL
    assert _rel(got, jfir.fir_apply(jnp.asarray(h), jnp.asarray(sig))) < FIR_TOL
    assert _rel(tfk.fir_direct(h, x), want) < FIR_TOL


@pytest.mark.parametrize("shape,taps", [((5, 777), 21), ((2, 50), 129),
                                        ((1, 7), 16)])
def test_fir_direct_odd_shapes_and_short_signals(rng, shape, taps):
    """Channels off the TPU's 8-tile, lengths off its block, n < taps."""
    x = rng.standard_normal(shape).astype(np.float32)
    h = jfir.design_lowpass_np(taps, 0.2)
    want = jpk.fir_apply_pallas(jnp.asarray(h, jnp.float32), jnp.asarray(x),
                                block_t=256, interpret=True)
    assert _rel(tfk.fir_direct(h, torch.as_tensor(x)), want) < FIR_TOL
    assert _rel(tfk.fir_direct(h, torch.as_tensor(x)),
                ss.lfilter(h, [1.0], x.astype(np.float64))) < FIR_TOL


@pytest.mark.parametrize("taps,ok", [(2048, True), (2049, False),
                                     (5000, False)])
def test_fir_direct_refuses_what_the_pallas_kernel_refuses(rng, taps, ok):
    x = rng.standard_normal((1, 64)).astype(np.float32)
    h = np.full(taps, 1.0 / taps)
    if ok:
        tfk.fir_direct(h, torch.as_tensor(x))
        jpk.fir_apply_pallas(jnp.asarray(h, jnp.float32), jnp.asarray(x),
                             interpret=True)
        return
    with pytest.raises(ValueError):
        tfk.fir_direct(h, torch.as_tensor(x))
    with pytest.raises(ValueError):
        jpk.fir_apply_pallas(jnp.asarray(h, jnp.float32), jnp.asarray(x),
                             interpret=True)


@pytest.mark.parametrize("up,down", [(2, 1), (1, 2), (4, 3), (3, 4), (7, 5)])
def test_poly_plain_matches_pallas_kernel(sig, spy, up, down):
    n = sig.shape[-1] // down * down
    x = sig[:, :n]
    want = np.asarray(jpk.resample_poly_pallas(jnp.asarray(x), up, down,
                                               q_tile=64, interpret=True))
    got = tfk.resample_poly_kernel(torch.as_tensor(x), up, down)
    assert spy == ["resample_poly_plain", "resample_poly"]
    assert got.shape == want.shape == (3, n * up // down)
    assert _rel(got, want) < RESAMPLE_TOL
    assert _rel(tfk.resample_poly_plain(torch.as_tensor(x), up, down),
                jrs.resample_poly(jnp.asarray(x), up, down)) < RESAMPLE_TOL
    assert _rel(got, ss.resample_poly(x.astype(np.float64), up, down,
                                      axis=-1)) < RESAMPLE_TOL


@pytest.mark.parametrize("up,down", [(1, 26), (30, 7)])
def test_poly_kernel_routes_large_tables_to_resample_poly(sig, spy, up,
                                                          down):
    """up * taps_pp > 512: the JAX launcher's static route to resample_poly,
    which never reaches the kernel's wrapper branch."""
    want = jpk.resample_poly_pallas(jnp.asarray(sig), up, down,
                                    interpret=True)
    got = tfk.resample_poly_kernel(torch.as_tensor(sig), up, down)
    assert spy == ["resample_poly"]
    assert _rel(got, want) < RESAMPLE_TOL


def test_poly_kernel_equal_rate_returns_the_input(sig, spy):
    x = torch.as_tensor(sig)
    assert tfk.resample_poly_kernel(x, 3, 3) is x
    assert tfk.resample_poly_best(x, 5, 5) is x
    assert spy == []


# taps -> the route the JAX package takes on the TPU
FIR_ROUTES = [(1, "fir_direct"), (16, "fir_direct"), (17, "fir_apply_mxu"),
              (64, "fir_apply_mxu"), (256, "fir_apply_mxu"),
              (511, "fir_apply_mxu"), (512, "upfirdn_banded"),
              (1024, "upfirdn_banded")]


@pytest.mark.parametrize("taps,route", FIR_ROUTES)
def test_fir_apply_best_routes_and_values(rng, spy, taps, route):
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    h = _lowpass(taps)
    got = tfk.fir_apply_best(h, torch.as_tensor(x))
    assert spy[0] == route
    assert got.shape == x.shape
    want = np.asarray(jpk.fir_apply_best(jnp.asarray(h, jnp.float32),
                                         jnp.asarray(x)))
    assert _rel(got, want) < FIR_TOL
    assert _rel(got, ss.lfilter(h, [1.0], x.astype(np.float64))) < FIR_TOL


def test_fir_apply_best_learned_taps_stay_on_the_matmul_route(rng, spy):
    """Taps that require grad never reach the banded kernel, as traced taps
    in JAX (pallas_kernels.py:459-461)."""
    x = torch.as_tensor(rng.standard_normal((2, 3000)), dtype=torch.float32)
    h = torch.as_tensor(_lowpass(1024), dtype=torch.float32)
    tfk.fir_apply_best(h.clone().requires_grad_(True), x)
    tfk.fir_apply_best(h, x)
    assert spy == ["fir_apply_mxu", "upfirdn_banded"]


def test_fir_apply_best_collapses_leading_axes(rng):
    x = rng.standard_normal((3, 2, 1000)).astype(np.float32)
    for taps in (16, 64, 1024):
        h = _lowpass(taps)
        with one_thread():   # the CPU result depends on the thread count
            got = tfk.fir_apply_best(h, torch.as_tensor(x))
            flat = tfk.fir_apply_best(h, torch.as_tensor(x.reshape(6, 1000)))
        assert got.shape == x.shape
        torch.testing.assert_close(got.reshape(6, 1000), flat, rtol=0,
                                   atol=0)
    one = tfk.fir_apply_best(_lowpass(16), torch.as_tensor(x[0, 0]))
    assert one.shape == (1000,)


# (up, down) -> the route the JAX package takes on the TPU
RESAMPLE_ROUTES = [(2, 1, "upfirdn_banded"), (1, 2, "upfirdn_banded"),
                   (4, 3, "upfirdn_banded"), (8, 6, "upfirdn_banded"),
                   (31, 30, "upfirdn_banded"), (32, 31, "resample_poly_mxu"),
                   (160, 147, "resample_poly_mxu")]


@pytest.mark.parametrize("up,down,route", RESAMPLE_ROUTES)
def test_resample_poly_best_routes_and_values(rng, spy, up, down, route):
    n = 6000 // down * down
    x = rng.standard_normal((2, n)).astype(np.float32)
    got = tfk.resample_poly_best(torch.as_tensor(x), up, down)
    assert spy[0] == route
    want = np.asarray(jpk.resample_poly_best(jnp.asarray(x), up, down))
    assert got.shape == want.shape == (2, -(-n * up // down))
    assert _rel(got, want) < RESAMPLE_TOL
    assert _rel(got, ss.resample_poly(x.astype(np.float64), up, down,
                                      axis=-1)) < RESAMPLE_TOL


def test_resample_poly_best_rank(rng):
    x = rng.standard_normal((3, 2, 3000)).astype(np.float32)
    with one_thread():   # the CPU result depends on the thread count
        got = tfk.resample_poly_best(torch.as_tensor(x), 4, 3)
        flat = tfk.resample_poly_best(torch.as_tensor(x.reshape(6, 3000)),
                                      4, 3)
    assert got.shape == (3, 2, 4000)
    torch.testing.assert_close(got.reshape(6, 4000), flat, rtol=0, atol=0)


@pytest.mark.parametrize("up,down", [(160, 147), (147, 160), (44, 3)])
def test_resample_multistage_matches_jax(rng, monkeypatch, up, down):
    """Each stage goes through resample_poly_best (the banded route at
    these stages); the cascade matches the JAX function's."""
    x = rng.standard_normal((2, 9000)).astype(np.float32)
    stages = []
    real = tfk.resample_poly_best
    monkeypatch.setattr(tfk, "resample_poly_best",
                        lambda v, u, d: (stages.append((u, d)),
                                         real(v, u, d))[1])
    got = trs.resample_multistage(torch.as_tensor(x), up, down)
    want = np.asarray(jrs.resample_multistage(jnp.asarray(x), up, down))
    assert stages == jrs._factor_stages(up, down)
    assert got.shape == want.shape == (2, -(-9000 * up // down))
    assert _rel(got, want) < RESAMPLE_TOL


@pytest.mark.parametrize("up,down", [(160, 147), (10, 11)])
def test_resample_multistage_takes_use_pallas(rng, monkeypatch, up, down):
    """The JAX signature (tests/test_resample.py:139, :156):
    ``use_pallas=False`` runs each stage through ``resample_poly``, as the
    JAX function does, and matches it at 1e-5 of max|y|; True and None
    keep ``resample_poly_best``."""
    x = rng.standard_normal((2, 2200)).astype(np.float32)
    want = np.asarray(jrs.resample_multistage(jnp.asarray(x), up, down,
                                              use_pallas=False))
    best = []
    real = tfk.resample_poly_best
    monkeypatch.setattr(tfk, "resample_poly_best",
                        lambda v, u, d: (best.append((u, d)),
                                         real(v, u, d))[1])
    got = trs.resample_multistage(torch.as_tensor(x), up, down,
                                  use_pallas=False)
    assert best == []
    assert got.shape == want.shape
    assert _rel(got, want) < RESAMPLE_TOL
    for flag in (True, None):
        got = trs.resample_multistage(torch.as_tensor(x), up, down, flag)
        assert got.shape == want.shape
    assert best == 2 * jrs._factor_stages(up, down)


def test_fir_resample_fused_takes_group(rng, monkeypatch):
    """The JAX signature (h_fir, x, up, down, group, algorithm): the
    positional call ``(h, x, 4, 3, None, "bf16")`` names the tier, not the
    taps; ``group=`` reaches the "torch" route's ``upfirdn_tall`` and
    changes no value; a group that is not a positive int raises."""
    h = jfir.design_lowpass_np(64, 0.3).astype(np.float32)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    want = np.asarray(jrs.fir_resample_fused(h, jnp.asarray(x), 4, 3,
                                             group=5))
    tiers = []
    real = trs.upfirdn_banded
    monkeypatch.setattr(trs, "upfirdn_banded",
                        lambda *a: (tiers.append(a[-1]), real(*a))[1])
    got = trs.fir_resample_fused(h, torch.as_tensor(x), 4, 3, None, "bf16")
    assert tiers == ["bf16"] and got.shape == want.shape
    got = trs.fir_resample_fused(h, torch.as_tensor(x), 4, 3, group=5,
                                 algorithm="f32")
    assert _rel(got, want) < RESAMPLE_TOL
    groups = []
    tall = trs.upfirdn_tall
    monkeypatch.setattr(trs, "head_route", lambda *a: "torch")
    monkeypatch.setattr(trs, "upfirdn_tall",
                        lambda *a: (groups.append(a[7:]), tall(*a))[1])
    for group in (None, 1, 5):
        got = trs.fir_resample_fused(h, torch.as_tensor(x), 4, 3, group,
                                     "f32")
        assert _rel(got, want) < RESAMPLE_TOL
    assert groups == [(None,), (1,), (5,)]
    for bad in (0, -2, 2.0, True):
        with pytest.raises(ValueError):
            trs.fir_resample_fused(h, torch.as_tensor(x), 4, 3, bad)


def test_factor_stages_match_jax():
    for up in (1, 2, 3, 7, 11, 44, 147, 160, 441, 1000):
        for down in (1, 3, 13, 147, 160, 480):
            assert trs._factor_stages(up, down) == jrs._factor_stages(up, down)


def test_banded_rule_equals_jax():
    for up in (1, 2, 3, 4, 7, 8, 31, 32, 160, 512, 513):
        for down in (1, 2, 3, 7, 147, 2000):
            for len_g in (1, 41, 161, 1024, 4096, 40_000):
                for offset in (0, (len_g - 1) // 2, len_g + 5):
                    args = (up, down, len_g, offset)
                    assert tuf.pick_b_out(*args) == jpu.pick_b_out(*args)
                    assert (tuf.banded_supported(*args)
                            == jpu.banded_supported(*args)), args
                    assert tuf._geometry(*args, 256) == jpu._geometry(
                        *args, 256)


@pytest.mark.parametrize("up,down", [(1, 1), (2, 1), (3, 2), (1, 3)])
def test_upfirdn_forms_match_jax_and_scipy(rng, up, down):
    x = rng.standard_normal((2, 1500)).astype(np.float32)
    h = jfir.design_lowpass_np(37, 0.2)
    want = ss.upfirdn(h, x.astype(np.float64), up, down, axis=-1)
    for port, jax_fn in ((trs.upfirdn, jrs.upfirdn),
                         (trs.upfirdn_mxu, jrs.upfirdn_mxu)):
        got = port(h, torch.as_tensor(x), up, down)
        assert got.shape == want.shape
        assert _rel(got, want) < RESAMPLE_TOL
        assert _rel(got, jax_fn(h, jnp.asarray(x), up, down)) < RESAMPLE_TOL


@pytest.mark.parametrize("up,down", [(4, 3), (160, 147), (3, 7)])
def test_resample_poly_mxu_and_frames_matmul_match_jax(rng, up, down):
    x = rng.standard_normal((2, 7000)).astype(np.float32)
    got = trs.resample_poly_mxu(torch.as_tensor(x), up, down)
    want = jrs.resample_poly_mxu(jnp.asarray(x), up, down)
    assert got.shape == want.shape
    assert _rel(got, want) < RESAMPLE_TOL
    h = jrs._resample_poly_filter(up, down)
    n_out = -(-7000 * up // down)
    got = trs._upfirdn_frames_matmul(h, torch.as_tensor(x), up, down,
                                     (len(h) - 1) // 2, n_out)
    assert _rel(got, want) < RESAMPLE_TOL


@pytest.mark.parametrize("taps", [1, 100, 128, 300])
def test_fir_apply_forms_match_jax(rng, taps):
    x = rng.standard_normal((2, 2, 777)).astype(np.float32)
    h = _lowpass(taps)
    want = ss.lfilter(h, [1.0], x.astype(np.float64))
    for port, jax_fn in ((tfir.fir_apply, jfir.fir_apply),
                         (tfir.fir_apply_mxu, jfir.fir_apply_mxu)):
        got = port(h, torch.as_tensor(x))
        assert got.shape == x.shape
        assert _rel(got, want) < FIR_TOL
        assert _rel(got, jax_fn(h, jnp.asarray(x))) < FIR_TOL
    got = tfir.fir_apply_mxu(torch.as_tensor(h), torch.as_tensor(x))
    assert _rel(got, want) < FIR_TOL


@pytest.mark.parametrize("n,up,down", [(8, 4, 3), (100, 4, 3), (3000, 3, 3),
                                       (50, 2, 1)])
def test_fused_head_short_and_equal_rate_match_jax(rng, n, up, down):
    h = jfir.design_lowpass_np(64, 0.3).astype(np.float32)
    x = rng.standard_normal((2, n)).astype(np.float32)
    want = np.asarray(jrs.fir_resample_fused(h, jnp.asarray(x), up, down))
    got = trs.fir_resample_fused(h, torch.as_tensor(x), up, down,
                                 algorithm="f32")
    assert got.shape == want.shape
    assert _rel(got, want) < RESAMPLE_TOL
    staged = ss.resample_poly(ss.lfilter(h, [1.0], x.astype(np.float64)),
                              up, down, axis=-1)[:, :got.shape[-1]]
    assert _rel(got, staged) < RESAMPLE_TOL


def test_staged_chain_matches_jax_and_fused_chain(rng, spy):
    x = rng.standard_normal((2, 24000)).astype(np.float32)
    want = JaxChain(fused_head=False)(jnp.asarray(x))
    staged = NorthStarChain(fused_head=False, device="cpu")
    got = staged(torch.as_tensor(x))
    assert spy == ["upfirdn_banded", "upfirdn_banded"]
    assert got.shape == want.shape == (2, 60, 20)
    assert _rel(got, want) < 5e-5
    fused = NorthStarChain(device="cpu")(torch.as_tensor(x))
    assert _rel(got, fused) < 1e-4


def test_staged_chain_f64_oracle(rng):
    from test_torch_pipeline import _chain_oracle
    x64 = rng.standard_normal((2, 30000))
    chain = NorthStarChain(fused_head=False, stft_algorithm="f32",
                           device="cpu")
    got = chain(torch.as_tensor(x64, dtype=torch.float32))
    assert _rel(got, _chain_oracle(x64, chain)) < 5e-5


@pytest.mark.parametrize("taps", [16, 64, 1024])
def test_fir_apply_best_gradients_are_the_plain_ones(rng, taps):
    """The kernel routes differentiate their plain form: d/dh and d/dx of
    fir_apply_best equal those of fir_apply at the same inputs (the banded
    route's numpy taps take no gradient)."""
    x = torch.as_tensor(rng.standard_normal((2, 1500)), dtype=torch.float32)
    h = torch.as_tensor(_lowpass(taps), dtype=torch.float32)
    cot = torch.as_tensor(rng.standard_normal((2, 1500)), dtype=torch.float32)
    with one_thread():   # the CPU result depends on the thread count
        xa = x.clone().requires_grad_(True)
        if taps == 1024:
            ha = h.numpy()
            (gx,) = torch.autograd.grad(tfk.fir_apply_best(ha, xa), xa, cot)
            gh = None
        else:
            ha = h.clone().requires_grad_(True)
            gx, gh = torch.autograd.grad(tfk.fir_apply_best(ha, xa),
                                         (xa, ha), cot)
        xb = x.clone().requires_grad_(True)
        hb = h.clone().requires_grad_(True)
        want_x, want_h = torch.autograd.grad(tfir.fir_apply(hb, xb),
                                             (xb, hb), cot)
    if taps == 16:   # the direct route's backward is fir_apply's own
        torch.testing.assert_close(gx, want_x, rtol=0, atol=0)
        torch.testing.assert_close(gh, want_h, rtol=0, atol=0)
    else:            # fir_apply_mxu's: the same function, another form
        assert _rel(gx, want_x) < FIR_TOL
        if gh is not None:
            assert _rel(gh, want_h) < FIR_TOL
