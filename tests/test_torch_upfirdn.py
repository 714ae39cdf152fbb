"""The port's banded upfirdn (plain version, the one a CPU tensor runs) and
fused FIR+resample head against the JAX package.

The JAX kernel runs in interpret mode, as its own tests run it. Both sides
form the same products at each tier (a bf16*bf16 product is exact in
float32) and sum them in another order, so the tolerance is 1e-5 of
max|y|: float32 summation noise over ~1000-term sums, 10x the measured
1.2e-6.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vv_dsp_tpu.models import NorthStarChain as JaxChain
from vv_dsp_tpu.ops import fir as jfir
from vv_dsp_tpu.ops import pallas_upfirdn as jpu
from vv_dsp_tpu.ops import resample as jrs
from vv_dsp_tpu_torch.ops import resample as trs
from vv_dsp_tpu_torch.ops import upfirdn as tuf
from torch_one_thread import one_thread

TOL = 1e-5


def _rel(got, want):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    return err / np.abs(want).max()


@pytest.fixture(scope="module")
def flagship():
    h = JaxChain().fir_coeffs.astype(np.float64)
    g, off = jrs._fused_fir_resample_filter(tuple(h), 4, 3)
    return h, g, off


@pytest.fixture
def sig(rng):
    return rng.standard_normal((2, 24000)).astype(np.float32)


@pytest.mark.parametrize("algorithm", ["f32", "bf16x3", "bf16"])
def test_plain_matches_pallas_kernel_per_tier(flagship, sig, algorithm):
    _, g, off = flagship
    n_out = -(-sig.shape[-1] * 4 // 3)
    want = jpu.upfirdn_banded_pallas(jnp.asarray(sig), g, 4, 3, off, n_out,
                                     interpret=True, algorithm=algorithm)
    taps = tuf.polyphase_table(g, 4, "cpu")
    got = tuf.upfirdn_banded(torch.as_tensor(sig), taps, 4, 3, off, n_out,
                             algorithm)
    assert got.shape == (2, n_out) and got.dtype == torch.float32
    assert _rel(got, want) < TOL


def test_tiers_differ_as_expected(flagship, sig):
    """bf16 rounds the operands once and must land measurably away from
    f32; bf16x3 recovers f32 to ~1e-5 (the JAX chain's 7.7e-6 head)."""
    _, g, off = flagship
    taps = tuf.polyphase_table(g, 4, "cpu")
    x = torch.as_tensor(sig)
    y = {a: tuf.upfirdn_tall(x, taps, 4, 3, off, 32000, a)
         for a in ("f32", "bf16x3", "bf16")}
    assert _rel(y["bf16x3"], y["f32"]) < 2e-5
    assert _rel(y["bf16"], y["f32"]) > 1e-4


def test_plain_matches_jax_upfirdn_tall(flagship, sig):
    _, g, off = flagship
    grp = tuf.default_group(1044, 3)
    want = jrs._upfirdn_tall(g, jnp.asarray(sig), 4, 3, off, 32000, grp)
    taps = tuf.polyphase_table(g, 4, "cpu")
    got = tuf.upfirdn_tall(torch.as_tensor(sig), taps, 4, 3, off, 32000, "f32",
                           grp)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("up,down", [(4, 3), (2, 1), (1, 2), (3, 4), (7, 5)])
def test_plain_resample_matches_pallas_kernel(rng, up, down):
    """Resampling alone at several ratios (the tall frames' geometry)."""
    x = rng.standard_normal((2, 5001)).astype(np.float32)
    h = jrs._resample_poly_filter(up, down)
    off = (len(h) - 1) // 2
    n_out = -(-x.shape[-1] * up // down)
    want = jpu.upfirdn_banded_pallas(jnp.asarray(x), h, up, down, off, n_out,
                                     b_out=up * 64, interpret=True,
                                     algorithm="f32")
    got = tuf.upfirdn_banded(torch.as_tensor(x),
                             tuf.polyphase_table(h, up, "cpu"), up, down, off,
                             n_out, "f32")
    assert _rel(got, want) < TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(jrs.resample_poly(
        jnp.asarray(x), up, down)), rtol=0, atol=2e-5)


@pytest.mark.parametrize("algorithm", ["f32", "bf16x3"])
def test_fir_resample_fused_matches_jax(flagship, sig, algorithm):
    """The whole head, staged tail included. JAX's CPU path computes in
    float32 at every tier, so bf16x3 is held to the tier's own error."""
    h, _, _ = flagship
    want = np.asarray(jrs.fir_resample_fused(h.astype(np.float32),
                                             jnp.asarray(sig), 4, 3))
    got = trs.fir_resample_fused(h.astype(np.float32), torch.as_tensor(sig),
                                 4, 3, algorithm=algorithm)
    assert got.shape == want.shape == (2, 32000)
    assert _rel(got, want) < (TOL if algorithm == "f32" else 2e-5)


def test_staged_tail_correction_is_applied(flagship, sig):
    """The last ~13 outputs follow the staged pair (FIR truncated at n),
    not the pure composite filter: without the correction they would be
    far outside the tolerance."""
    h, g, off = flagship
    x = torch.as_tensor(sig)
    n_in, n_out = sig.shape[-1], 32000
    m0 = -(-(4 * n_in - off) // 3)
    fused = trs.fir_resample_fused(h.astype(np.float32), x, 4, 3,
                                   algorithm="f32").numpy()
    composite = tuf.upfirdn_tall(x, tuf.polyphase_table(g, 4, "cpu"), 4, 3,
                                 off, n_out, "f32").numpy()
    np.testing.assert_array_equal(fused[:, :m0], composite[:, :m0])
    staged = np.asarray(jrs.resample_poly(
        jfir.fir_apply(jnp.asarray(h.astype(np.float32)), jnp.asarray(sig)),
        4, 3))
    scale = np.abs(staged).max()
    assert np.abs(fused[:, m0:] - staged[:, m0:]).max() / scale < TOL
    assert np.abs(composite[:, m0:] - staged[:, m0:]).max() / scale > 1e-3


def test_fused_head_against_float64_scipy(flagship, rng):
    from scipy import signal as ss
    h, _, _ = flagship
    x64 = rng.standard_normal((2, 30000))
    want = ss.resample_poly(ss.lfilter(h, [1.0], x64, axis=-1), 4, 3,
                            axis=-1)[:, :40000]
    got = trs.fir_resample_fused(h.astype(np.float32),
                                 torch.as_tensor(x64, dtype=torch.float32),
                                 4, 3, algorithm="f32")
    assert _rel(got, want) < TOL


def test_fused_head_rank_and_dtype(flagship, rng):
    h, _, _ = flagship
    x = rng.standard_normal((3, 2, 6000)).astype(np.float32)
    with one_thread():   # the CPU result depends on the thread count
        got = trs.fir_resample_fused(h.astype(np.float32),
                                     torch.as_tensor(x), 4, 3,
                                     algorithm="f32")
        flat = trs.fir_resample_fused(h.astype(np.float32),
                                      torch.as_tensor(x.reshape(6, 6000)), 4,
                                      3, algorithm="f32")
    assert got.shape == (3, 2, 8000)
    torch.testing.assert_close(got.reshape(6, 8000), flat, rtol=0, atol=0)
    pcm = torch.as_tensor((x[0] * 1000).astype(np.int16))
    assert trs.fir_resample_fused(h, pcm, 4, 3).dtype == torch.float32


@pytest.mark.parametrize("n,up,down", [(8, 4, 3), (300, 4, 3), (3000, 2, 2),
                                        (500, 1, 1)])
def test_short_signal_and_equal_rate_branches(flagship, rng, n, up, down):
    """Signals shorter than the resample filter take the staged pair over
    the whole output; up == down is the FIR alone (fir_apply_mxu), as in
    the JAX function."""
    h, _, _ = flagship
    x = rng.standard_normal((2, n)).astype(np.float32)
    want = np.asarray(jrs.fir_resample_fused(h.astype(np.float32),
                                             jnp.asarray(x), up, down))
    got = trs.fir_resample_fused(h.astype(np.float32), torch.as_tensor(x),
                                 up, down, algorithm="f32")
    assert got.shape == want.shape == (2, -(-n * up // down))
    assert _rel(got, want) < TOL


def test_head_always_goes_through_the_kernel_wrapper(flagship, monkeypatch):
    """fir_resample_fused hands every geometry to upfirdn_banded with the
    caller's tier: the wrapper runs the plain version on a CPU tensor and
    the kernel (or raises) on a CUDA tensor, so a filter far beyond one
    block's shared memory takes no other path."""
    h, _, _ = flagship
    calls = []
    real = tuf.upfirdn_banded

    def spy(x, taps, up, down, offset, n_out, algorithm=None):
        calls.append((tuple(taps.shape), algorithm))
        if taps.numel() > 100_000:   # the plain matrix would be huge
            return torch.zeros(x.shape[0], n_out)
        return real(x, taps, up, down, offset, n_out, algorithm)

    monkeypatch.setattr(trs, "upfirdn_banded", spy)
    trs.fir_resample_fused(h, torch.zeros(1, 6000), 4, 3, algorithm="bf16")
    long_h = np.full(40_000, 1 / 40_000)
    y = trs.fir_resample_fused(long_h, torch.zeros(1, 60_000), 4, 3,
                               algorithm="bf16x3")
    assert y.shape == (1, 80_000)
    assert calls == [((4, 1044), "bf16"), ((4, 40_020), "bf16x3")]


def test_kernel_wrapper_refuses_other_devices(flagship):
    _, g, off = flagship
    x = torch.zeros(2, 100, device="meta")
    with pytest.raises(ValueError):
        tuf.upfirdn_banded(x, torch.zeros(4, 1044, device="meta"), 4, 3, off,
                           133)


def _staged_out_of_place(h, x, off, n_out, route_tail=None):
    """The fused head as the cat of the composite's first m0 columns and
    the staged tail (the definition the kernel route differentiates)."""
    m0 = max(0, -(-(4 * x.shape[-1] - off) // 3))
    g, _ = trs._fused_fir_resample_filter(tuple(h), 4, 3)
    composite = tuf.upfirdn_tall(x, tuf.polyphase_table(g, 4, "cpu"), 4, 3,
                                 off, n_out, "f32")
    tail = trs._staged_tail(h, x, 4, 3, off, m0, n_out)
    return torch.cat([composite[..., :m0], tail], -1), m0


@pytest.mark.parametrize("n", [24000, 8])
def test_fused_head_writes_its_tail_into_the_kernel_buffer(flagship, rng,
                                                           monkeypatch, n):
    """The head returns upfirdn_banded's own buffer, its last columns
    overwritten by the staged tail: a dense matmul tail at the chain's
    geometry (n = 24000, 13 outputs) and the staged pair over the whole
    output (n = 8, m0 = 0). Its values are the out-of-place definition's,
    bit for bit, and each call counts one tail written in place."""
    h, _, off = flagship
    buffers = []
    real = tuf.upfirdn_banded

    def spy(*args):
        buffers.append(real(*args))
        return buffers[-1]

    monkeypatch.setattr(trs, "upfirdn_banded", spy)
    x = torch.as_tensor(rng.standard_normal((2, n)), dtype=torch.float32)
    n_out = -(-n * 4 // 3)
    before = trs.fir_resample_fused.tails_in_place
    with one_thread():
        got = trs.fir_resample_fused(h, x, 4, 3, algorithm="f32")
        want, m0 = _staged_out_of_place(h, x, off, n_out)
    assert (m0, n_out - m0) == ((31987, 13) if n > 8 else (0, 11))
    assert trs.fir_resample_fused.tails_in_place == before + 1
    assert len(buffers) == 1
    assert (got.untyped_storage().data_ptr()
            == buffers[0].untyped_storage().data_ptr())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("route", ["banded", "torch"])
def test_fused_head_gradient_is_the_staged_definitions(flagship, rng,
                                                       monkeypatch, route):
    """The tail written in place keeps the gradient of the staged
    definition, on the kernel route (the write inside the vjp shim's
    forward) and on the "torch" route (autograd follows the write): a
    cotangent on every column, and one on the tail alone, which must
    reach x through the staged tail, not through the composite's."""
    h, g, off = flagship
    if route == "torch":
        monkeypatch.setattr(trs, "head_route", lambda *a: "torch")
    x0 = torch.as_tensor(rng.standard_normal((2, 6000)), dtype=torch.float32)
    n_out = 8000
    cot = torch.as_tensor(rng.standard_normal((2, n_out)),
                          dtype=torch.float32)
    m0 = max(0, -(-(4 * 6000 - off) // 3))
    tail_only = torch.zeros_like(cot)
    tail_only[..., m0:] = cot[..., m0:]

    def grad_of(fn, c):
        x = x0.clone().requires_grad_(True)
        fn(x).backward(c)
        return x.grad

    fused = lambda x: trs.fir_resample_fused(h, x, 4, 3, algorithm="f32")
    staged = lambda x: _staged_out_of_place(h, x, off, n_out)[0]
    composite = lambda x: tuf.upfirdn_tall(
        x, tuf.polyphase_table(g, 4, "cpu"), 4, 3, off, n_out, "f32")
    with one_thread():
        for c in (cot, tail_only):
            want = grad_of(staged, c)
            assert _rel(grad_of(fused, c), want) < 1e-6
        assert _rel(grad_of(composite, tail_only), want) > 1e-3
