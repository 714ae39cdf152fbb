"""The PyTorch port's host constant builders against the JAX package's.

The port copies its numpy float64 builders instead of importing them (the
JAX modules import jax), so each copy must give the same array: exactly
where the code is the same, within 1e-12 where only the float64 evaluation
order can differ. params_from_reference must carry the JAX chain's arrays
into a port chain that computes what a port-built chain computes.
"""

import numpy as np
import pytest
import torch

from vv_dsp_tpu.models import NorthStarChain as JaxChain
from vv_dsp_tpu.ops import dct as jdct
from vv_dsp_tpu.ops import fir as jfir
from vv_dsp_tpu.ops import mel as jmel
from vv_dsp_tpu.ops import pallas_fft as jpf
from vv_dsp_tpu.ops import pallas_upfirdn as jpu
from vv_dsp_tpu.ops import resample as jrs
from vv_dsp_tpu.ops import window as jwin
from vv_dsp_tpu_torch.convert import params_from_reference
from vv_dsp_tpu_torch.models import NorthStarChain, chain_params
from vv_dsp_tpu_torch.ops import dct as tdct
from vv_dsp_tpu_torch.ops import fir as tfir
from vv_dsp_tpu_torch.ops import mel as tmel
from vv_dsp_tpu_torch.ops import resample as trs
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops import upfirdn as tuf
from vv_dsp_tpu_torch.ops import window as twin
from torch_one_thread import one_thread


def _flagship_fir():
    return JaxChain().fir_coeffs.astype(np.float64)


@pytest.mark.parametrize("name,n,param", [
    ("hann", 1024, None), ("hann", 2048, None), ("hamming", 1024, None),
    ("kaiser", 81, 5.0), ("blackman", 513, None), ("tukey", 64, 0.3)])
def test_windows_equal(name, n, param):
    np.testing.assert_array_equal(twin.get_window_np(name, n, param),
                                  jwin.get_window_np(name, n, param))


def test_torch_window_is_f32_cast():
    w = twin.get_window("hann", 2048)
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(
        w.numpy(), jwin.get_window_np("hann", 2048).astype(np.float32))


@pytest.mark.parametrize("taps,cutoff", [(1024, 0.45), (129, 0.3)])
def test_design_lowpass_equal(taps, cutoff):
    np.testing.assert_array_equal(tfir.design_lowpass_np(taps, cutoff),
                                  jfir.design_lowpass_np(taps, cutoff))


@pytest.mark.parametrize("up,down", [(4, 3), (3, 4), (7, 5), (2, 1)])
def test_resample_poly_filter_equal(up, down):
    np.testing.assert_array_equal(trs._resample_poly_filter(up, down),
                                  jrs._resample_poly_filter(up, down))


def test_composite_filter_equal():
    h = tuple(_flagship_fir())
    g_t, off_t = trs._fused_fir_resample_filter(h, 4, 3)
    g_j, off_j = jrs._fused_fir_resample_filter(h, 4, 3)
    assert off_t == off_j == 40 and len(g_t) == len(g_j) == 4173
    np.testing.assert_array_equal(g_t, g_j)


@pytest.mark.parametrize("n_in", [24000, 48000, 479232])
def test_staged_tail_matrix_equal(n_in):
    h = tuple(_flagship_fir())
    _, off = trs._fused_fir_resample_filter(h, 4, 3)
    n_out = -(-n_in * 4 // 3)
    m0 = max(0, -(-(4 * n_in - off) // 3))
    w_t, j_t = trs._staged_tail_matrix(h, 4, 3, off, n_in, m0, n_out - m0)
    w_j, j_j = jrs._staged_tail_matrix(h, 4, 3, off, n_in, m0, n_out - m0)
    assert j_t == j_j and w_t.shape == w_j.shape
    assert 0 < n_out - m0 <= 16  # ~13 outputs cross the FIR's end
    np.testing.assert_array_equal(w_t, w_j)


def test_polyphase_table_matches_band_matrix():
    """taps[p, i] = g[p + i*up] reproduces every row of the JAX kernel's
    banded weight matrix: row t (output t of a segment) at column i (input
    j_lo0 + i) holds taps[phase_t, anchor_t - j_lo0 - i]."""
    g, off = jrs._fused_fir_resample_filter(tuple(_flagship_fir()), 4, 3)
    b_out = jpu.pick_b_out(4, 3, len(g), off)
    _, j_lo0, k_wp = jpu._geometry(4, 3, len(g), off, b_out)
    band = jpu._band_matrix(tuple(g), 4, 3, off, b_out, j_lo0, k_wp)
    taps = tuf.polyphase_table_np(g, 4)
    assert taps.shape == (4, 1044)
    t = off + np.arange(b_out) * 3
    anchor, phase = t // 4, t % 4
    i = anchor[:, None] - j_lo0 - np.arange(k_wp)[None, :]
    ok = (i >= 0) & (i < taps.shape[1])
    rebuilt = np.where(ok, taps[phase[:, None], np.clip(i, 0, 1043)], 0.0)
    np.testing.assert_array_equal(rebuilt, band)


def test_mel_filterbank_equal():
    np.testing.assert_array_equal(
        tmel.mel_filterbank_np(2048, 80, 64000.0, 0.0, 32000.0),
        jmel.mel_filterbank_np(2048, 80, 64000.0, 0.0, 32000.0))
    np.testing.assert_array_equal(
        tmel.mel_filterbank_np(512, 26, 16000.0, 0.0, 8000.0, "slaney"),
        jmel.mel_filterbank_np(512, 26, 16000.0, 0.0, 8000.0, "slaney"))


@pytest.mark.parametrize("hz", [0.0, 440.0, 1000.0, 31999.0])
def test_mel_scale_equal(hz):
    for variant in ("htk", "slaney"):
        m = tmel.hz_to_mel(hz, variant)
        assert m == jmel.hz_to_mel(hz, variant)
        assert tmel.mel_to_hz(m, variant) == jmel.mel_to_hz(m, variant)


@pytest.mark.parametrize("n_mels,n_mfcc,lifter", [(80, 20, 0.0),
                                                  (26, 13, 22.0)])
def test_dct_and_lifter_equal(n_mels, n_mfcc, lifter):
    np.testing.assert_array_equal(tdct._dct2_matrix(n_mels),
                                  jdct._dct2_matrix(n_mels))
    np.testing.assert_array_equal(tmel._lifter_np(n_mfcc, lifter),
                                  jmel._lifter_np(n_mfcc, lifter))
    # the fused kernel's liftered DCT rows (pallas_fft.stft_mfcc_pallas)
    want = (jdct._dct2_matrix(n_mels)[:n_mfcc]
            * jmel._lifter_np(n_mfcc, lifter)[:, None])
    np.testing.assert_array_equal(tmel.mfcc_dct_np(n_mels, n_mfcc, lifter),
                                  want)


@pytest.mark.parametrize("nfft", [512, 2048])
def test_fft_tables_match_jax_twiddles(nfft):
    """The butterflies' table is the JAX kernels' stage-0 twiddle row; the
    unpack table, reordered by the JAX packed row -> bin map, is theirs."""
    tw, wk = tsk._fft_tables(nfft, torch.device("cpu"))
    m = nfft // 2
    twr, twi = jpf._stage_twiddles(m, 1)
    np.testing.assert_array_equal(tw[:, 0].numpy(), twr[0, :m // 2])
    np.testing.assert_array_equal(tw[:, 1].numpy(), twi[0, :m // 2])
    wkr, wki = jpf._packed_wk(nfft, 64)
    rows = np.arange(m)
    nb = m // 64
    k = (rows % 64) * nb + jpf._bitrev_perm(nb)[rows // 64]
    np.testing.assert_allclose(wk[k, 0].numpy(), wkr[:, 0], rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(wk[k, 1].numpy(), wki[:, 0], rtol=0,
                               atol=1e-7)


def _reference_arrays():
    ref = JaxChain()
    fir = ref.fir_coeffs
    g, off = jrs._fused_fir_resample_filter(tuple(fir.astype(np.float64)),
                                            ref.up, ref.down)
    sr = ref.sample_rate * ref.up / ref.down
    return dict(
        fir_coeffs=fir, window=jwin.get_window_np(ref.window, ref.nfft),
        g=g, offset=off,
        mel_fb=jmel.mel_filterbank_np(ref.nfft, ref.n_mels, sr, 0.0, sr / 2),
        dct_lift=(jdct._dct2_matrix(ref.n_mels)[:ref.n_mfcc]
                  * jmel._lifter_np(ref.n_mfcc, 0.0)[:, None]))


def test_params_from_reference_equal_port_builders():
    got = params_from_reference(**_reference_arrays())
    want = chain_params()
    assert set(got) == set(want)
    assert got["offset"] == want["offset"]
    assert got["fir_coeffs"].dtype == want["fir_coeffs"].dtype == np.float32
    for name in ("fir_coeffs", "window", "g", "mel_fb", "dct_lift"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_chain_from_reference_params_computes_the_same(rng):
    x = torch.as_tensor(rng.standard_normal((2, 9000)), dtype=torch.float32)
    params = params_from_reference(**_reference_arrays())
    with one_thread():   # the CPU result depends on the thread count
        a = NorthStarChain(params=params, device="cpu")(x)
        b = NorthStarChain(device="cpu")(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    chain = NorthStarChain(params=params, device="cpu")
    for name in ("head_taps", "window", "mel_fb", "dct_lift"):
        assert getattr(chain, name).dtype == torch.float32
    assert chain.mel_bands.dtype == torch.int32
    assert {n for n, _ in chain.named_buffers()} == {
        "head_taps", "window", "mel_fb", "mel_bands", "dct_lift"}


def test_params_from_reference_rejects_bad_shapes():
    arrays = _reference_arrays()
    arrays["mel_fb"] = arrays["mel_fb"][:, :-1]
    with pytest.raises(ValueError):
        params_from_reference(**arrays)
