"""The port's full-nfft inverse STFT (``istft_stockham``), its packed fused
gate (``stft_gate_packed``) and the 128-point routes of ``STFT.process``
and ``reconstruct`` against the JAX package on the CPU. The port runs its
kernels' plain versions; the JAX Pallas kernels run in interpret mode.

Tolerances, as fractions of the JAX output's max |value|:
- istft_stockham: tests/test_pallas_fft.py's two pins, 5e-6 on samples
  more than nfft from either end (1e-2 where hop == nfft, where every
  frame boundary is a zero of the Hann window's w^2 norm) and 1e-2 on all
  samples (at the edges the 1/w^2 norm amplifies float32 rounding);
- stft_gate_packed: 5e-6 of max(1, scale) on every sample of the
  COLA-padded input (tests/test_pallas_fft.py's pin, there on the retained
  samples), at threshold 0.1 on seeds where a float64 oracle puts no bin
  within 1e-4 (relative) of the threshold, so no bin can flip between the
  two FFTs' roundings; threshold 0 returns the input at 3e-5 absolute
  (tests/test_tpu_hardware.py's pin);
- the 128-point routes: 5e-6 (1e-2 where hop == nfft, as above): the same
  plain versions as before the route changed, so the numbers do not move.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vv_dsp_tpu.ops import pallas_fft as jpf
from vv_dsp_tpu.ops.stft import STFT as JaxSTFT
from vv_dsp_tpu.ops.window import get_window_np
from vv_dsp_tpu_torch.models import SpectralGate
from vv_dsp_tpu_torch.ops import istft_kernels as tik
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops import stockham_kernels as tstk
from vv_dsp_tpu_torch.ops.stft import STFT


def _istft_port(spec, nfft, hop, n, rfft):
    sp = torch.as_tensor(np.array(spec))
    norm = tik.ola_norm(get_window_np("hann", nfft), hop, sp.shape[1], n,
                        "cpu")
    return tstk.istft_stockham(sp, nfft, hop, n, STFT(nfft, hop).win("cpu"),
                               norm, rfft=rfft).numpy()


def _istft_close(got, want, nfft, hop):
    scale = np.abs(want).max() + 1e-30
    e = nfft
    tight = 5e-6 if hop < nfft else 1e-2
    assert np.abs(got - want)[:, e:-e].max() / scale < tight
    assert np.abs(got - want).max() / scale < 1e-2


@pytest.mark.parametrize("rfft_flag,nfft,hop,n", [
    (True, 256, 64, 3000),
    (False, 256, 64, 3000),
    (True, 512, 128, 2100),
    (True, 512, 512, 2048)])
def test_istft_stockham_matches_jax(rng, rfft_flag, nfft, hop, n):
    """tests/test_pallas_fft.py's geometries; the JAX kernel's spectrum."""
    x = jnp.asarray(rng.standard_normal((2, n)).astype(np.float32))
    spec = JaxSTFT(nfft, hop).process(x, rfft=rfft_flag)
    want = np.asarray(jpf.istft_stockham(spec, nfft, hop, n, "hann",
                                         rfft=rfft_flag))
    got = _istft_port(spec, nfft, hop, n, rfft_flag)
    assert got.shape == want.shape
    _istft_close(got, want, nfft, hop)


def test_istft_stockham_inverts_all_bins_without_rfft(rng):
    """A non-Hermitian spectrum: with rfft=False the port's istft_stockham
    is JAX's full-bin function (the real part of each frame's complex
    inverse), where reconstruct reads bins 0..nfft/2 only."""
    nfft, hop, n = 256, 64, 3000
    nf = 1 + (n - nfft + hop) // hop
    spec = (rng.standard_normal((2, nf, nfft))
            + 1j * rng.standard_normal((2, nf, nfft))).astype(np.complex64)
    want = np.asarray(jpf.istft_stockham(jnp.asarray(spec), nfft, hop, n,
                                         "hann", rfft=False))
    got = _istft_port(spec, nfft, hop, n, False)
    _istft_close(got, want, nfft, hop)
    half = STFT(nfft, hop).reconstruct(torch.as_tensor(spec), n).numpy()
    e = nfft
    inner = np.abs(got[:, e:-e]).max()
    assert np.abs(half - got)[:, e:-e].max() / inner > 0.1


def test_istft_stockham_rfft_drops_dc_and_nyquist_imaginary_parts(rng):
    nfft, hop, n = 256, 64, 3000
    x = torch.as_tensor(rng.standard_normal((1, n)), dtype=torch.float32)
    spec = STFT(nfft, hop).process(x, rfft=True)
    bent = spec.clone()
    bent[..., 0] += 1j
    bent[..., -1] -= 2j
    win = STFT(nfft, hop).win("cpu")
    norm = tik.ola_norm(get_window_np("hann", nfft), hop, spec.shape[1], n,
                        "cpu")
    got = tstk.istft_stockham(bent, nfft, hop, n, win, norm, rfft=True)
    want = tstk.istft_stockham(spec, nfft, hop, n, win, norm, rfft=True)
    assert (got - want).abs().max().item() < 1e-6
    with pytest.raises(ValueError):
        tstk.istft_stockham(spec, nfft, hop, n, win, norm, rfft=False)


def _padded(nfft, hop, seed):
    n, pad = 4 * nfft, nfft - hop
    x = np.zeros((2, n + 2 * pad), np.float32)
    x[:, pad:pad + n] = np.random.default_rng(seed).standard_normal((2, n))
    return x, pad, n


def _gate_port(x, nfft, hop, t, algorithm=None):
    win = STFT(nfft, hop).win("cpu")
    norm = tik.periodic_norm(get_window_np("hann", nfft), hop, x.shape[-1],
                             "cpu")
    return tik.stft_gate_packed(torch.as_tensor(x), nfft, hop, t, win, norm,
                                algorithm).numpy()


def _near_threshold(x, nfft, hop, t) -> int:
    """Bins of a float64 oracle within 1e-4 (relative) of t^2 times their
    frame's peak power."""
    xd = x.astype(np.float64)
    nf = 1 + (xd.shape[-1] - nfft + hop) // hop
    idx = np.arange(nf)[:, None] * hop + np.arange(nfft)[None, :]
    xp = np.pad(xd, ((0, 0), (0, max(0, idx.max() + 1 - xd.shape[-1]))))
    p2 = np.abs(np.fft.rfft(xp[:, idx] * get_window_np("hann", nfft))) ** 2
    level = t * t * p2.max(-1, keepdims=True)
    return int(((np.abs(p2 - level) <= 1e-4 * level) & (level > 0)).sum())


@pytest.mark.parametrize("nfft,hop,seed", [(512, 128, 5), (1024, 256, 6)])
def test_stft_gate_packed_matches_jax(nfft, hop, seed):
    """n = 4 nfft, COLA-padded, every sample."""
    x, pad, n = _padded(nfft, hop, seed)
    assert _near_threshold(x, nfft, hop, 0.1) == 0
    want = np.asarray(jpf.stft_gate_packed(jnp.asarray(x), nfft, hop, 0.1,
                                           interpret=True))
    got = _gate_port(x, nfft, hop, 0.1)
    assert got.shape == want.shape == x.shape
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() / scale < 5e-6
    got0 = _gate_port(x, nfft, hop, 0.0)
    np.testing.assert_allclose(got0[:, pad:pad + n], x[:, pad:pad + n],
                               rtol=0, atol=3e-5)


def test_stft_gate_packed_is_the_split_pair_on_retained_samples(rng):
    """The same function as SpectralGate's split pair (spectrum -> gated
    inverse) on the samples SpectralGate keeps, where the periodic norm is
    the exact one."""
    nfft, hop = 1024, 256
    x, pad, n = _padded(nfft, hop, 6)
    got = _gate_port(x, nfft, hop, 0.1)
    want = SpectralGate(nfft, hop, 0.1, device="cpu")(
        torch.as_tensor(x[:, pad:pad + n])).numpy()
    assert np.abs(got[:, pad:pad + n] - want).max() / np.abs(want).max() \
        < 5e-6


def test_periodic_norm_is_the_exact_norm_where_frames_cover(rng):
    w = get_window_np("hann", 512)
    n = 4000
    nf = 1 + (n - 512 + 128) // 128
    per = tik.periodic_norm_np(w, 128, n)
    exact = tik.ola_norm_np(w, 128, nf, n)
    cover = slice(512 - 128, (nf - 1) * 128 + 128)
    np.testing.assert_allclose(per[cover], exact[cover], rtol=1e-6)
    assert per.shape == (n,) and per.dtype == np.float32


def test_stft_gate_packed_refuses_other_tiers_and_devices():
    x, _, _ = _padded(512, 128, 5)
    for tier in ("bf16x3", "bf16"):
        with pytest.raises(ValueError):
            _gate_port(x, 512, 128, 0.1, tier)
    np.testing.assert_array_equal(_gate_port(x, 512, 128, 0.1, "f32"),
                                  _gate_port(x, 512, 128, 0.1))
    with pytest.raises(ValueError):
        tik.stft_gate_packed(torch.zeros(1, 4096, device="meta"), 512, 128,
                             0.1, torch.zeros(512), torch.ones(4096))
    for fn in (tik.stft_gate_packed, tstk.istft_stockham):
        assert isinstance(fn.launches, int)


@pytest.fixture
def spies(monkeypatch):
    """Record which wrapper each entry point calls (the wrappers still run:
    on a CPU tensor, their plain versions)."""
    calls = []
    names = {tsk: ("stft_spectrum",), tik: ("istft", "stft_gate_packed"),
             tstk: ("stft_spectrum_stockham", "istft_stockham",
                    "stft_gate_stockham")}
    for mod, fns in names.items():
        for name in fns:
            def spy(*args, _f=getattr(mod, name), _name=name, **kw):
                calls.append(_name)
                return _f(*args, **kw)
            monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("nfft,hop,want", [
    (128, 32, ["stft_spectrum_stockham", "istft_stockham",
               "stft_gate_stockham"]),
    (128, 128, ["stft_spectrum_stockham", "istft_stockham"]),
    (1024, 256, ["stft_spectrum", "istft", "stft_spectrum", "istft"]),
    (256, 64, ["stft_spectrum", "istft", "stft_spectrum", "istft"])])
def test_128_point_routes(spies, nfft, hop, want):
    """process and reconstruct at nfft = 128 take the full-nfft kernels (the
    inverse in its rfft=True form, with rfft=False too); SpectralGate keeps
    its routes (the fused full-nfft gate where hop < nfft at 128, the split
    pair at 1024/256 and 256/64, no wrapper at 128/128, which no kernel
    takes), and stft_gate_packed runs only by its own name."""
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((1, 3000)),
                        dtype=torch.float32)
    plan = STFT(nfft, hop)
    spec = plan.process(x, rfft=True)
    y = plan.reconstruct(torch.cat([spec, spec[..., 1:-1].flip(-1).conj()],
                                   -1), 3000)
    SpectralGate(nfft, hop, 0.1, device="cpu")(x)
    assert spies == want
    jplan = JaxSTFT(nfft, hop)
    jwant = np.asarray(jplan.reconstruct(jplan.process(jnp.asarray(x.numpy()),
                                                       rfft=True), 3000,
                                         rfft=True))
    e = nfft
    tight = 5e-6 if hop < nfft else 1e-2
    assert np.abs(y.numpy() - jwant)[:, e:-e].max() / np.abs(jwant).max() \
        < tight


@pytest.mark.parametrize("rfft", [False, True])
def test_128_point_process_and_roundtrip_match_jax(rng, rfft):
    nfft, hop, n = 128, 32, 3000
    x = rng.standard_normal((2, n)).astype(np.float32)
    jplan, plan = JaxSTFT(nfft, hop), STFT(nfft, hop)
    want = np.asarray(jplan.process(jnp.asarray(x), rfft=rfft))
    got = plan.process(torch.as_tensor(x), rfft=rfft)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 5e-6
    back = plan.reconstruct(got, n, rfft=rfft).numpy()
    jback = np.asarray(jplan.reconstruct(jnp.asarray(want), n, rfft=rfft))
    e = nfft
    assert np.abs(back - jback)[:, e:-e].max() / np.abs(jback).max() < 5e-6
    np.testing.assert_allclose(back[:, e:-e], x[:, e:-e], rtol=0, atol=3e-5)
