"""The port's framing-free STFT parts family against the JAX package on the
CPU: the host DFT bases, ``STFT.power_parts`` and ``reconstruct_parts``,
``spectrogram``, the mel functions built on the power and on its parts,
and the windowed-DFT power spectrogram (``stft_power_dft``, the port of
``stft_power_pallas``, which runs in interpret mode here). The port runs
plain PyTorch (on a CPU tensor ``stft_power_dft`` runs its plain version).

Tolerances, as fractions of the JAX output's max |value| unless named
otherwise:
- bases: equal (the same float64 numpy, cast the same way);
- power_parts, reconstruct_parts, spectrogram, log-mel and mel energies:
  5e-6 (float32 products in another summation order; reconstruct_parts
  on samples more than nfft from either end, where the w^2 norm is full:
  at the edges its 1/w^2 amplifies float32 rounding without bound);
- MFCC: 5e-4 absolute (the fused-MFCC pin of tests/test_pallas_fft.py);
- stft_power_dft: 1e-5 of max power (tests/test_pallas.py's pin), at
  that test's four geometries, and the same refusals.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vv_dsp_tpu.ops import fft as jfft
from vv_dsp_tpu.ops import mel as jmel
from vv_dsp_tpu.ops import pallas_kernels as jpk
from vv_dsp_tpu.ops import stft as jstft
from vv_dsp_tpu.ops.stft import STFT as JaxSTFT
from vv_dsp_tpu_torch.ops import fft as tfft
from vv_dsp_tpu_torch.ops import mel as tmel
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops.stft import STFT, stft_spectrogram


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n", [64, 256, 1000])
@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_dft_bases_are_the_jax_packages(n, kind):
    np.testing.assert_array_equal(tfft._dft_basis(n, kind),
                                  jfft._dft_basis(n, kind))
    for part in ("re", "im"):
        np.testing.assert_array_equal(
            tfft._basis_cast(n, kind, part, "float32"),
            jfft._basis_cast(n, kind, part, "float32"))


@pytest.mark.parametrize("nfft,window,param", [(512, "hann", None),
                                               (1024, "kaiser", 8.0)])
def test_windowed_basis_is_the_jax_packages(nfft, window, param):
    got = tsk._windowed_rfft_basis(nfft, window, param, "float32")
    want = jstft._windowed_rfft_basis(nfft, window, param, "float32")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# (nfft, hop, window, n): hop == nfft, n < nfft, one channel in (1, n)
PARTS_GEOMETRIES = [(1024, 256, "hann", 6000), (512, 128, "hamming", 3000),
                    (256, 256, "hann", 2000), (512, 64, "hann", 300)]


@pytest.mark.parametrize("nfft,hop,window,n", PARTS_GEOMETRIES)
def test_power_parts_match_jax(rng, nfft, hop, window, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    jplan, plan = JaxSTFT(nfft, hop, window), STFT(nfft, hop, window)
    want = jplan.power_parts(jnp.asarray(x))
    got = plan.power_parts(torch.as_tensor(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) < 5e-6
    nf = plan.num_frames(n) + 2       # frames past the signal: zeros
    got = plan._power_direct(torch.as_tensor(x), nf)
    want = jplan._power_direct(jnp.asarray(x), nf)
    assert got.shape == want.shape and _rel(got, want) < 5e-6


def test_power_parts_take_leading_axes_and_refuse_complex(rng):
    x = rng.standard_normal((2, 3, 2000)).astype(np.float32)
    plan = STFT(512, 128)
    re, im = plan.power_parts(torch.as_tensor(x))
    want = JaxSTFT(512, 128).power_parts(jnp.asarray(x))
    assert re.shape == want[0].shape == (2, 3, 13, 257)
    assert _rel(re, want[0]) < 5e-6 and _rel(im, want[1]) < 5e-6
    with pytest.raises(TypeError):
        plan.power_parts(torch.zeros(1, 2000, dtype=torch.complex64))


@pytest.mark.parametrize("nfft,hop,window,n", PARTS_GEOMETRIES[:3])
def test_reconstruct_parts_match_jax(rng, nfft, hop, window, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    jplan, plan = JaxSTFT(nfft, hop, window), STFT(nfft, hop, window)
    jre, jim = jplan.power_parts(jnp.asarray(x))
    want = np.asarray(jplan.reconstruct_parts(jre, jim, n))
    got = plan.reconstruct_parts(torch.as_tensor(np.asarray(jre)),
                                 torch.as_tensor(np.asarray(jim)), n)
    assert got.shape == want.shape
    e = nfft
    assert _rel(got[:, e:-e], want[:, e:-e]) < 5e-6
    if hop < nfft:   # the parts roundtrip is the identity where COLA holds
        np.testing.assert_allclose(got[:, e:-e], x[:, e:-e], rtol=0,
                                   atol=3e-5)


@pytest.mark.parametrize("nfft,hop,n", [(1024, 256, 6000), (512, 128, 300),
                                        (128, 32, 3000)])
def test_spectrogram_matches_jax(rng, nfft, hop, n):
    x = rng.standard_normal((2, n)).astype(np.float32)
    want = np.asarray(JaxSTFT(nfft, hop).spectrogram(jnp.asarray(x)))
    got = STFT(nfft, hop).spectrogram(torch.as_tensor(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < 5e-6
    got = stft_spectrogram(torch.as_tensor(x), nfft, hop)
    want = np.asarray(jstft.stft_spectrogram(jnp.asarray(x), nfft, hop))
    assert _rel(got, want) < 5e-6


@pytest.mark.parametrize("nfft,n_mels,n_mfcc,sr,lifter", [
    (512, 40, 13, 16000.0, 0.0), (1024, 26, 13, 16000.0, 22.0)])
def test_mel_functions_match_jax(rng, nfft, n_mels, n_mfcc, sr, lifter):
    x = rng.standard_normal((2, 6000)).astype(np.float32)
    hop = nfft // 4
    jre, jim = JaxSTFT(nfft, hop).power_parts(jnp.asarray(x))
    re = torch.as_tensor(np.asarray(jre))
    im = torch.as_tensor(np.asarray(jim))
    power = re * re + im * im
    jpower = jre * jre + jim * jim
    assert _rel(tmel.log_mel_spectrogram(power, nfft, n_mels, sr),
                jmel.log_mel_spectrogram(jpower, nfft, n_mels, sr)) < 5e-6
    assert _rel(tmel.mel_energies_from_power_parts(re, im, nfft, n_mels, sr,
                                                   100.0, 7000.0),
                jmel.mel_energies_from_power_parts(jre, jim, nfft, n_mels,
                                                   sr, 100.0, 7000.0)) < 5e-6
    for got, want in (
            (tmel.mfcc_from_power_parts(re, im, nfft, n_mels, n_mfcc, sr,
                                        lifter=lifter),
             jmel.mfcc_from_power_parts(jre, jim, nfft, n_mels, n_mfcc, sr,
                                        lifter=lifter)),
            (tmel.mfcc(power, nfft, n_mels, n_mfcc, sr, lifter=lifter),
             jmel.mfcc(jpower, nfft, n_mels, n_mfcc, sr, lifter=lifter))):
        assert got.shape == want.shape == (2, re.shape[1], n_mfcc)
        assert np.abs(got.numpy() - np.asarray(want)).max() < 5e-4


@pytest.mark.parametrize("nfft,hop,win,n", [(2048, 512, "hann", 48000),
                                            (1024, 256, "hamming", 10000),
                                            (1024, 1024, "hann", 5000),
                                            (2048, 512, "hann", 1000)])
def test_stft_power_dft_matches_stft_power_pallas(rng, nfft, hop, win, n):
    """tests/test_pallas.py's geometries, the short signal (n < nfft)
    included; also against STFT.power, as that test holds the JAX kernel."""
    x = rng.standard_normal((3, n)).astype(np.float32)
    want = np.asarray(jpk.stft_power_pallas(jnp.asarray(x), nfft, hop, win))
    got = tsk.stft_power_dft(torch.as_tensor(x), nfft, hop, win)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() / max(want.max(), 1e-9) < 1e-5
    plain = STFT(nfft, hop, win).power(torch.as_tensor(x))
    assert (got - plain).abs().max() / plain.max() < 1e-5


def test_stft_power_dft_n_frames(rng):
    """More frames than the signal's (zeros past it), as the JAX kernel
    computes them; fewer (which the JAX launcher cannot pad for) are the
    first frames of the default count."""
    x = rng.standard_normal((2, 5000)).astype(np.float32)
    want = np.asarray(jpk.stft_power_pallas(jnp.asarray(x), 1024, 256,
                                            n_frames=25))
    got = tsk.stft_power_dft(torch.as_tensor(x), 1024, 256, n_frames=25)
    assert got.shape == want.shape == (2, 25, 513)
    assert np.abs(got.numpy() - want).max() / want.max() < 1e-5
    got = tsk.stft_power_dft(torch.as_tensor(x), 1024, 256, n_frames=3)
    torch.testing.assert_close(got, torch.as_tensor(want[:, :3]), rtol=0,
                               atol=1e-5 * float(want.max()))


def test_stft_power_dft_refuses_what_stft_power_pallas_refuses(rng):
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    for nfft, hop in ((1000, 250), (2048, 640)):
        with pytest.raises(ValueError):
            jpk.stft_power_pallas(jnp.asarray(x), nfft, hop)
        with pytest.raises(ValueError):
            tsk.stft_power_dft(torch.as_tensor(x), nfft, hop)
    with pytest.raises(ValueError):
        tsk.stft_power_dft(torch.zeros(1, 4096, device="meta"), 1024, 256)
    assert isinstance(tsk.stft_power_dft.launches, int)
