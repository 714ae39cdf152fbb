"""The port's STFT kernels' plain versions (what a CPU tensor runs) against
the JAX package's packed-real Pallas kernels in interpret mode.

Tolerances are the JAX package's own for these kernels:
- MFCC: 5e-4 absolute (tests/test_pallas_fft.py's fused-MFCC pin); the log
  of low-energy mel bands turns float32 FFT noise into absolute error;
- mel energies and the spectrum: 5e-5 of max |value|, the FFT-class
  parity contract (tests/test_pallas_fft.py's packed-spectrum pin).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vv_dsp_tpu.ops import pallas_fft as jpf
from vv_dsp_tpu.ops.stft import STFT as JaxSTFT
from vv_dsp_tpu_torch.ops import mel as tmel
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops.framing import frames_strided, stft_num_frames
from vv_dsp_tpu_torch.ops.stft import STFT
from torch_one_thread import one_thread


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.fixture
def sig(rng):
    return rng.standard_normal((2, 24000)).astype(np.float32)


@pytest.mark.parametrize("algorithm", ["bf16x3", "f32"])
def test_plain_mfcc_matches_pallas_chain_geometry(sig, algorithm):
    args = (2048, 512, 80, 20, 64000.0)
    want = jpf.stft_mfcc_pallas(jnp.asarray(sig), *args, interpret=True,
                                algorithm=algorithm)
    got = tmel.mfcc_stft(torch.as_tensor(sig), *args, algorithm=algorithm)
    assert got.shape == want.shape == (2, 44, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-4)


def test_plain_mfcc_matches_pallas_lifter(sig):
    args = (512, 128, 26, 13, 16000.0)
    want = jpf.stft_mfcc_pallas(jnp.asarray(sig), *args, lifter=22.0,
                                interpret=True)
    got = tmel.mfcc_stft(torch.as_tensor(sig), *args, lifter=22.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-4)


def test_plain_mel_energies_match_pallas(sig):
    want = jpf.stft_mel_energies_pallas(jnp.asarray(sig), 2048, 512, 80,
                                        64000.0, interpret=True,
                                        algorithm="f32")
    win, fb, bands, _ = tmel._mfcc_constants(2048, 80, 20, 64000.0, 0.0,
                                             32000.0, 0.0, "htk", "hann",
                                             None, torch.device("cpu"))
    got = tsk.stft_mfcc(torch.as_tensor(sig), 2048, 512, win, fb, bands,
                        None, algorithm="f32")
    assert got.shape == want.shape == (2, 44, 80)
    assert _rel(got, want) < 5e-5


@pytest.mark.parametrize("nfft,hop,onesided", [
    (1024, 256, False), (1024, 256, True), (2048, 512, False),
    (2048, 512, True)])
def test_plain_spectrum_matches_pallas(sig, nfft, hop, onesided):
    want = jpf.stft_spectrum_packed(jnp.asarray(sig), nfft, hop,
                                    onesided=onesided, interpret=True)
    got = STFT(nfft, hop).process(torch.as_tensor(sig), rfft=onesided)
    assert got.dtype == torch.complex64
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < 5e-5


@pytest.mark.parametrize("onesided", [False, True])
@pytest.mark.parametrize("pad", [0, 768, 333])
@pytest.mark.parametrize("n", [700, 1024, 5000])
def test_spectrum_pad_is_the_padded_input(rng, onesided, pad, n):
    """A zero pad of pad samples at both ends, taken by the plain version
    and by the wrapper on a CPU tensor, is F.pad of the input, bit for bit:
    n below, at and above nfft, no pad, the gate's 1024/256 pad and an odd
    one."""
    x = torch.as_tensor(rng.standard_normal((2, n)), dtype=torch.float32)
    win = STFT(1024, 256).win(x.device)
    xp = torch.nn.functional.pad(x, (pad, pad))
    before = tsk.stft_spectrum.edge_pads
    with one_thread():
        want = tsk.stft_spectrum_plain(xp, 1024, 256, win, onesided)
        got = tsk.stft_spectrum_plain(x, 1024, 256, win, onesided, pad)
        wrapped = tsk.stft_spectrum(x, 1024, 256, win, onesided, pad=pad)
    assert want.shape[1] == stft_num_frames(n + 2 * pad, 1024, 256)
    assert got.shape == want.shape and wrapped.shape == want.shape
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    assert torch.equal(torch.view_as_real(wrapped), torch.view_as_real(want))
    # a CPU tensor launches nothing
    assert tsk.stft_spectrum.edge_pads == before


def test_spectrum_refuses_a_negative_pad():
    x = torch.zeros(2, 4096)
    with pytest.raises(ValueError, match="pad"):
        tsk.stft_spectrum(x, 1024, 256, torch.ones(1024), pad=-1)


@pytest.mark.parametrize("n", [1500, 2047, 9001])
def test_edge_lengths_short_and_ragged(rng, n):
    """n < nfft (one zero-padded frame) and n not a multiple of hop (a
    zero-padded tail frame): frame counts and values follow the JAX
    kernels."""
    x = rng.standard_normal((2, n)).astype(np.float32)
    nf = stft_num_frames(n, 2048, 512)
    assert nf == JaxSTFT(2048, 512).num_frames(n)
    want = jpf.stft_spectrum_packed(jnp.asarray(x), 2048, 512,
                                    interpret=True)
    got = STFT(2048, 512).process(torch.as_tensor(x))
    assert got.shape == want.shape == (2, nf, 2048)
    assert _rel(got.numpy(), want) < 5e-5
    want = jpf.stft_mfcc_pallas(jnp.asarray(x), 2048, 512, 80, 20, 64000.0,
                                interpret=True)
    got = tmel.mfcc_stft(torch.as_tensor(x), 2048, 512, 80, 20, 64000.0,
                         algorithm="bf16x3")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-4)


def test_frames_strided_zero_pads_tail():
    x = torch.arange(10.0)
    fr = frames_strided(x, 4, 3, stft_num_frames(10, 4, 3))
    assert fr.shape == (4, 4)
    torch.testing.assert_close(fr[-1], torch.tensor([9.0, 0.0, 0.0, 0.0]))
    fr = frames_strided(x, 8, 4, stft_num_frames(10, 8, 4))
    torch.testing.assert_close(fr[-1],
                               torch.tensor([4.0, 5, 6, 7, 8, 9, 0, 0]))
    assert stft_num_frames(3, 8, 4) == 1


def test_stft_supported_gate():
    assert tsk.stft_supported(2048, 512) and tsk.stft_supported(1024, 256)
    assert tsk.stft_supported(4096, 1000)   # no hop % 16 condition here
    assert not tsk.stft_supported(128, 32)
    assert not tsk.stft_supported(8192, 512)
    assert not tsk.stft_supported(1000, 250)
    assert not tsk.stft_supported(1024, 2048)


def test_unsupported_geometry_runs_plain_path(sig, monkeypatch):
    """nfft 1000, and nfft 128 at a hop that does not divide it, are no
    kernel geometry: the entry points take the "torch" route, the plain
    version on any device, and call no kernel wrapper. As the JAX
    package's XLA route, the MFCC products there take the knob's tier
    ("f32" by default), not the caller's `algorithm`."""
    calls = []
    spectrum, mfcc = tsk.stft_spectrum, tsk.stft_mfcc

    def spy_spectrum(x, nfft, *args, **kw):
        calls.append(("spectrum", nfft))
        return spectrum(x, nfft, *args, **kw)

    def spy_mfcc(x, nfft, hop, window, mel_fb, bands, dct, log_eps,
                 algorithm):
        calls.append(("mfcc", nfft, algorithm))
        return mfcc(x, nfft, hop, window, mel_fb, bands, dct, log_eps,
                    algorithm)

    monkeypatch.setattr(tsk, "stft_spectrum", spy_spectrum)
    monkeypatch.setattr(tsk, "stft_mfcc", spy_mfcc)
    got = STFT(1000, 250).process(torch.as_tensor(sig))
    want = JaxSTFT(1000, 250).process(jnp.asarray(sig))
    assert _rel(got.numpy(), want) < 5e-5
    x = torch.as_tensor(sig)
    win, fb, _, dct = tmel._mfcc_constants(128, 20, 13, 16000.0, 0.0,
                                           8000.0, 0.0, "htk", "hann", None,
                                           torch.device("cpu"))
    with one_thread():   # the CPU result depends on the thread count
        got = tmel.mfcc_stft(x, 128, 24, 20, 13, 16000.0, algorithm="bf16")
        want = tsk.stft_mfcc_plain(x, 128, 24, win, fb, dct, 1e-10, "f32")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert calls == []


def test_band_edges_cover_every_nonzero_weight():
    fb = tmel.mel_filterbank_np(2048, 80, 64000.0, 0.0, 32000.0)
    bands = tsk.band_edges_np(fb)
    assert bands.dtype == np.int32 and bands.shape == (2, 80)
    lo, hi = bands
    cols = np.arange(fb.shape[1])[None, :]
    inside = (cols >= lo[:, None]) & (cols < hi[:, None])
    assert (fb[~inside] == 0).all()
    assert (fb[np.arange(80), lo] != 0).all()
    assert (fb[np.arange(80), hi - 1] != 0).all()
    assert (hi > lo).all() and (hi - lo).max() < 200
    assert (tsk.band_edges_np(np.zeros((3, 9))) == 0).all()


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros(2, 4096, device="meta")
    w = torch.zeros(2048, device="meta")
    with pytest.raises(ValueError):
        tsk.stft_spectrum(x, 2048, 512, w)
    with pytest.raises(ValueError):
        tsk.stft_mfcc(x, 2048, 512, w, torch.zeros(80, 1025, device="meta"),
                      torch.zeros(2, 80, dtype=torch.int32, device="meta"))
