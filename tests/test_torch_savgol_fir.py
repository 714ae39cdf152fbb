"""The port's filter tier against the JAX package on the CPU, on the same
numpy input: Savitzky-Golay (every mode, derivatives, the NaN policy,
complex input), its kernel path (kernel 1, the banded upfirdn, at 1/1 and
offset wl - 1: the plain version against the JAX kernel in interpret mode,
and the tensor-core plan of ``ops/mma_plan.py`` replayed in float64 at the
window lengths 5-257), the FFT and overlap-save FIR, filtfilt, and the
reference's linear and sinc resamplers with their interpolators.

Tolerances, of the JAX output's max |value| unless named otherwise:
- savgol_filter: 1e-5 (tests/test_savgol.py holds the JAX function to
  float64 scipy at 1e-4; both sides float32 here); coefficients equal;
- the kernel path's plain version against the JAX kernel in interpret
  mode: 1e-5, the upfirdn dense-input limit of chip_smoke.py;
- the plan's float64 replay: 1e-12 of scale against a float64
  correlation; its f32 tier (six bf16 products of three parts)
  emulated in float64: 1e-6 of scale, also at deriv 1, whose weights sum
  to 0;
- fir_apply_fft, fir_apply_os, filtfilt_fir: 1e-5, tighter than
  tests/test_fir.py's 2e-4 absolute between its own forms; design: equal;
- interpolators and resample_linear: 1e-6; resample_sinc: 1e-5
  (tests/test_resample.py: 1e-4 and 1e-3 against their oracles).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vv_dsp_tpu.ops import fir as jfir
from vv_dsp_tpu.ops import pallas_upfirdn as jpu
from vv_dsp_tpu.ops import resample as jrs
from vv_dsp_tpu.ops import savgol as jsg
from vv_dsp_tpu.utils.nan_policy import NanPolicy as JNanPolicy
from vv_dsp_tpu_torch.ops import fir as tfir
from vv_dsp_tpu_torch.ops import mma_plan as mp
from vv_dsp_tpu_torch.ops import resample as trs
from vv_dsp_tpu_torch.ops import savgol as tsg
from vv_dsp_tpu_torch.ops import upfirdn as tuf
from vv_dsp_tpu_torch.utils.nan_policy import NanPolicy
from test_torch_mma_plan import _replay

WINDOWS = (5, 11, 31, 101, 257)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture
def sig(rng):
    return rng.standard_normal((2, 600)).astype(np.float32)


# ---- Savitzky-Golay ----

@pytest.mark.parametrize("mode", tsg.MODES)
@pytest.mark.parametrize("wl,order,deriv", [(11, 3, 0), (31, 4, 1),
                                            (9, 3, 2)])
def test_savgol_matches_jax(sig, mode, wl, order, deriv):
    np.testing.assert_array_equal(tsg.savgol_coeffs_np(wl, order, deriv, 0.5),
                                  jsg.savgol_coeffs_np(wl, order, deriv, 0.5))
    got = tsg.savgol_filter(torch.as_tensor(sig), wl, order, deriv, 0.5, mode)
    want = jsg.savgol_filter(jnp.asarray(sig), wl, order, deriv, 0.5, mode)
    assert got.shape == sig.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("policy", list(NanPolicy))
def test_savgol_nan_policy_and_complex_input_match_jax(sig, policy):
    x = sig.copy()
    x[0, 100], x[1, 7] = np.nan, np.inf
    got = tsg.savgol_filter(torch.as_tensor(x), 7, 2, nan_policy=policy)
    want = np.asarray(jsg.savgol_filter(jnp.asarray(x), 7, 2,
                                        nan_policy=JNanPolicy(policy.value)))
    # where the JAX conv's window meets a non-finite sample, so does the
    # port's; the kernel path's frames (of the banded matmul's width, as on
    # the TPU) may reach a few outputs further
    finite = np.isfinite(got.numpy())
    assert not (finite & ~np.isfinite(want)).any()
    assert finite.sum() >= np.isfinite(want).sum() - 64
    assert np.abs(got.numpy()[finite] - want[finite]).max() < \
        1e-5 * np.abs(want[finite]).max()
    z = (sig[0] + 1j * sig[1]).astype(np.complex64)
    got = tsg.savgol_filter(torch.as_tensor(z), 9, 3, mode="wrap")
    assert got.dtype == torch.complex64
    assert _rel(got, jsg.savgol_filter(jnp.asarray(z), 9, 3,
                                       mode="wrap")) < 1e-5


def test_savgol_routes_and_refusals(sig, monkeypatch):
    """Real float32 input runs the banded upfirdn at 1/1, offset wl - 1 (on
    a CPU tensor its plain version); float64 and complex input the conv.
    Its gradient is the shift-add correlation's."""
    calls = []
    banded = tuf.upfirdn_banded

    def spy(x, table, up, down, offset, n_out, algorithm=None):
        calls.append((up, down, offset, n_out, table.shape))
        return banded(x, table, up, down, offset, n_out, algorithm)

    monkeypatch.setattr(tsg, "upfirdn_banded", spy)
    x = torch.tensor(sig, requires_grad=True)
    tsg.savgol_filter(x, 31, 3).sum().backward()
    assert calls == [(1, 1, 30, 600, (1, 31))]
    w = tsg.savgol_coeffs_np(31, 3)
    # d/dx of sum(y): each sample collects the weights of the outputs it
    # reaches (the mirror padding folds the edges); in the interior, sum(w)
    torch.testing.assert_close(x.grad[:, 40:-40],
                               torch.full((2, 520), float(w.sum())))
    tsg.savgol_filter(torch.as_tensor(sig, dtype=torch.float64), 31, 3)
    tsg.savgol_filter(torch.as_tensor(sig[0] + 1j * sig[1]), 31, 3)
    assert len(calls) == 1
    assert all(tsg.takes_kernel(torch.zeros(1), wl) for wl in WINDOWS)
    for args in ((259, 3), (10, 3), (11, 11)):
        with pytest.raises(ValueError):
            tsg.savgol_filter(torch.as_tensor(sig), *args)
    with pytest.raises(ValueError):
        tsg.savgol_filter(torch.zeros(1, 10), 31, 3)
    with pytest.raises(ValueError):
        tsg.savgol_filter(torch.as_tensor(sig), 11, 3, mode="mirror")


@pytest.mark.parametrize("wl", [5, 31])
def test_savgol_kernel_path_matches_the_jax_kernel(rng, wl):
    """The plain versions of the kernel path (the tall-frames matmul the
    wrapper runs on a CPU tensor, and the shift-add correlation) against
    the JAX banded kernel in interpret mode on the padded 2 x 2,048."""
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    w = tsg.savgol_coeffs_np(wl, 3)
    xp = tsg._pad(torch.as_tensor(x), wl // 2, "reflect")
    n_out = xp.shape[-1] - wl + 1
    want = jpu.upfirdn_banded_pallas(jnp.asarray(xp.numpy()), w[::-1], 1, 1,
                                     wl - 1, n_out, interpret=True,
                                     algorithm="f32")
    table = tuf.polyphase_table(w[::-1], 1, "cpu")
    got = tuf.upfirdn_banded(xp, table, 1, 1, wl - 1, n_out, "f32")
    assert _rel(got, want) < 1e-5
    shift = tsg.correlate_plain(xp, torch.as_tensor(w, dtype=torch.float32),
                                n_out)
    assert _rel(shift, want) < 1e-5


@pytest.mark.parametrize("wl", WINDOWS)
@pytest.mark.parametrize("deriv", [0, 1])
def test_savgol_plan_replays_the_correlation(rng, wl, deriv):
    """The tensor-core plan at savgol's geometry (1/1, offset wl - 1): a
    layout that fits a block, whose B replayed pass by pass in float64
    gives the correlation, and whose f32 tier (the three bf16 parts of A
    and B, six products) holds it to 1e-6 of scale."""
    w = tsg.savgol_coeffs_np(wl, 3, deriv)
    table = tuf.polyphase_table_np(w[::-1], 1)
    plan = mp.upfirdn_plan(1, 1, wl, wl - 1, "f32")
    assert mp.upfirdn_fits(1, 1, wl, wl - 1, "f32")
    assert plan.smem <= mp.SMEM_BYTES and plan.k_pad >= wl
    x = rng.standard_normal((1, 3000))
    xp = tsg._pad(torch.as_tensor(x), wl // 2, "reflect").numpy()
    n_out = xp.shape[-1] - wl + 1
    want = sum(np.float64(table[0, wl - 1 - t]) * xp[:, t:t + n_out]
               for t in range(wl))
    band = mp.band_matrix_np(table, plan)
    scale = np.abs(want).max()
    assert np.abs(_replay(xp, plan, band, n_out) - want).max() <= \
        1e-12 * scale
    a_parts = mp.split_parts_np(xp, 3)
    b_parts = [mp.from_core_layout_np(q).astype(np.float64)
               for q in mp.band_parts_np(table, plan, "f32")]
    tier = sum(_replay(a_parts[i].astype(np.float64), plan, b_parts[j],
                       n_out) for i, j in mp.PRODUCTS["f32"])
    assert np.abs(tier - want).max() < 1e-6 * scale


# ---- FIR ----

@pytest.mark.parametrize("taps", [1, 16, 257])
def test_fir_forms_match_jax(sig, taps):
    h = jfir.design_lowpass_np(taps, 0.3) if taps > 1 else np.array([0.7])
    np.testing.assert_array_equal(
        tfir.design_lowpass(max(taps, 2), 0.3, device="cpu").numpy(),
        np.asarray(jfir.design_lowpass(max(taps, 2), 0.3)))
    tx, jx = torch.as_tensor(sig), jnp.asarray(sig)
    for name, args in (("fir_apply_fft", ()), ("fir_apply_os", ()),
                       ("fir_apply_os", (300,)), ("filtfilt_fir", ())):
        got = getattr(tfir, name)(h, tx, *args)
        want = getattr(jfir, name)(h, jx, *args)
        assert got.shape == sig.shape, name
        assert _rel(got, want) < 1e-5, (name, args)
    # a tensor of taps stays differentiable through the rfft forms
    ht = torch.tensor(h, requires_grad=True)
    tfir.fir_apply_os(ht, tx.double(), 64).sum().backward()
    assert ht.grad is not None and torch.isfinite(ht.grad).all()


def test_filtfilt_refuses_a_short_signal():
    with pytest.raises(ValueError):
        tfir.filtfilt_fir(np.ones(33) / 33, torch.zeros(2, 20))


# ---- the reference's resamplers ----

@pytest.mark.parametrize("l,m", [(3, 2), (2, 3), (160, 147)])
def test_resamplers_match_jax(sig, l, m):
    tx, jx = torch.as_tensor(sig), jnp.asarray(sig)
    assert trs.output_length(600, l, m) == jrs.output_length(600, l, m)
    assert _rel(trs.resample_linear(tx, l, m),
                jrs.resample_linear(jx, l, m)) < 1e-6
    for taps in (31, 8):
        np.testing.assert_array_equal(trs._sinc_phase_table(l, m, taps),
                                      jrs._sinc_phase_table(l, m, taps))
        got = trs.resample_sinc(tx, l, m, taps)
        assert got.shape == (2, jrs.output_length(600, l, m))
        assert _rel(got, jrs.resample_sinc(jx, l, m, taps)) < 1e-5


def test_interpolators_match_jax(sig):
    pos = np.array([-2.0, 0.0, 0.25, 3.5, 598.75, 599.0, 700.0])
    tx, jx = torch.as_tensor(sig), jnp.asarray(sig)
    for name in ("interpolate_linear", "interpolate_catmull_rom"):
        assert _rel(getattr(trs, name)(tx, pos),
                    getattr(jrs, name)(jx, jnp.asarray(pos))) < 1e-6
