"""The port's synthesis slice against the JAX package on the CPU: the power
spectrogram, the inverse STFT with its w^2 norm and gate, the packed
roundtrip, SpectralGate and MFCCFrontend. The port runs its kernels' plain
versions; the JAX packed kernels run in interpret mode.

Tolerances, as fractions of max |value| unless named otherwise:
- inverse STFT: 5e-6 of scale on samples more than nfft from either end
  (tests/test_pallas_fft.py's pin: at the edges the 1/w^2 norm amplifies
  float32 rounding without bound);
- power spectrogram and mel energies: 5e-5, the FFT-class contract;
- SpectralGate and the gated inverse: 5e-6 of max(1, scale) on the
  retained samples, on inputs where a float64 oracle puts no bin within
  1e-4 (relative) of the threshold, so no bin can flip between the two
  FFTs' roundings; threshold 0 returns the input at 5e-4 absolute
  (tests/test_models.py's pin);
- MFCC: 5e-4 absolute (the fused-MFCC pin of tests/test_pallas_fft.py);
- norm tables: equal as float32.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vv_dsp_tpu.models import MFCCFrontend as JaxFrontend
from vv_dsp_tpu.models import SpectralGate as JaxGate
from vv_dsp_tpu.ops import fft as jfft
from vv_dsp_tpu.ops.dct import _dct2_matrix
from vv_dsp_tpu.ops import mel as jmel
from vv_dsp_tpu.ops import pallas_fft as jpf
from vv_dsp_tpu.ops.stft import STFT as JaxSTFT
from vv_dsp_tpu.ops.stft import power_spectrogram_onesided as jax_power_os
from vv_dsp_tpu.ops.window import get_window_np
from vv_dsp_tpu_torch import convert
from vv_dsp_tpu_torch.models import MFCCFrontend, SpectralGate
from vv_dsp_tpu_torch.ops import framing as tfr
from vv_dsp_tpu_torch.ops import istft_kernels as tik
from vv_dsp_tpu_torch.ops import mel as tmel
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops.stft import STFT, power_spectrogram_onesided


def _interior_err(got, want, e):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max() + 1e-30
    return np.abs(got[..., e:-e] - want[..., e:-e]).max() / scale


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("rfft", [True, False])
@pytest.mark.parametrize("nfft,hop,n", [(512, 128, 4000), (1024, 256, 6000)])
def test_reconstruct_matches_packed_inverse(rng, rfft, nfft, hop, n):
    """rfft=False: both read bins 0..nfft//2 of the two-sided spectrum."""
    x = rng.standard_normal((2, n)).astype(np.float32)
    spec = np.asarray(JaxSTFT(nfft, hop).process(jnp.asarray(x), rfft=rfft))
    want = jpf.istft_packed(jnp.asarray(spec), nfft, hop, n, rfft=rfft,
                            interpret=True)
    got = STFT(nfft, hop).reconstruct(torch.as_tensor(spec), n, rfft=rfft)
    assert got.shape == (2, n) and got.dtype == torch.float32
    assert _interior_err(got, want, nfft) < 5e-6


@pytest.mark.parametrize("nfft,hop", [(512, 128), (2048, 512)])
def test_power_matches_packed_power(rng, nfft, hop):
    n = nfft * 4 + hop * 3
    x = rng.standard_normal((2, n)).astype(np.float32)
    want = jpf.stft_power_packed(jnp.asarray(x), nfft, hop, interpret=True)
    got = STFT(nfft, hop).power(torch.as_tensor(x))
    assert got.shape == want.shape == (2, 1 + (n - nfft + hop) // hop,
                                       nfft // 2 + 1)
    assert _rel(got, want) < 5e-5
    win = STFT(nfft, hop).win()
    torch.testing.assert_close(
        got, tsk.stft_power_plain(torch.as_tensor(x), nfft, hop, win),
        rtol=0, atol=0)


def _padded_noise(rng, nfft, hop, n, channels=2):
    pad = nfft - hop
    x = np.zeros((channels, n + 2 * pad), np.float32)
    x[:, pad:pad + n] = rng.standard_normal((channels, n))
    return x, pad


def _min_threshold_distance(xp, nfft, hop, threshold):
    """Smallest |p2 - t^2 peak2| / (t^2 peak2) over every bin of xp's
    frames, in float64 (frames of zeros, whose bins are all kept, left
    out)."""
    n = xp.shape[-1]
    nf = 1 + (n - nfft + hop) // hop
    w = get_window_np("hann", nfft, None)
    xe = np.pad(xp.astype(np.float64),
                ((0, 0), (0, (nf - 1) * hop + nfft - n)))
    frames = np.stack([xe[:, i * hop:i * hop + nfft] for i in range(nf)], 1)
    p2 = np.abs(np.fft.rfft(frames * w, axis=-1)) ** 2
    p2 = p2[p2.max(axis=-1) > 0]
    level = threshold ** 2 * p2.max(axis=-1, keepdims=True)
    return (np.abs(p2 - level) / level).min()


@pytest.mark.parametrize("nfft,hop", [(1024, 256), (512, 128)])
def test_gated_inverse_matches_split_gate(rng, nfft, hop):
    xp, pad = _padded_noise(rng, nfft, hop, nfft * 4)
    assert _min_threshold_distance(xp, nfft, hop, 0.1) > 1e-4
    want = np.asarray(jpf.stft_gate_split(jnp.asarray(xp), nfft, hop, 0.1,
                                          interpret=True))
    x = torch.as_tensor(xp)
    win = STFT(nfft, hop).win()
    spec = tsk.stft_spectrum_plain(x, nfft, hop, win, onesided=True)
    norm = tik.ola_norm(get_window_np("hann", nfft), hop, spec.shape[1],
                        xp.shape[-1], "cpu")
    got = tik.istft_plain(spec, nfft, hop, xp.shape[-1], win, norm, 0.1)
    scale = max(1.0, np.abs(want).max())
    n = xp.shape[-1] - 2 * pad
    err = np.abs(got.numpy()[:, pad:pad + n] - want[:, pad:pad + n]).max()
    assert err / scale < 5e-6
    gate = SpectralGate(nfft, hop, 0.1, device="cpu")
    torch.testing.assert_close(gate(x[:, pad:pad + n]), got[:, pad:pad + n],
                               rtol=0, atol=0)


@pytest.mark.parametrize("nfft,hop,threshold,n,seed", [
    (512, 128, 0.2, 8000, 9), (1024, 256, 0.1, 8192, 1)])
def test_spectral_gate_matches_jax(nfft, hop, threshold, n, seed):
    """Seeds whose noise keeps every bin clear of the threshold."""
    x = np.random.default_rng(seed).standard_normal((2, n)).astype(
        np.float32)
    pad = nfft - hop
    assert _min_threshold_distance(np.pad(x, ((0, 0), (pad, pad))), nfft,
                                   hop, threshold) > 1e-4
    want = np.asarray(JaxGate(nfft, hop, threshold)(jnp.asarray(x)))
    got = SpectralGate(nfft, hop, threshold, device="cpu")(
        torch.as_tensor(x))
    assert got.shape == (2, n) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() / max(1.0, np.abs(want).max()) \
        < 5e-6


def test_spectral_gate_threshold_zero_is_identity(rng):
    x = rng.standard_normal((2, 8000)).astype(np.float32)
    got = SpectralGate(threshold=0.0, device="cpu")(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), x, rtol=0, atol=5e-4)
    got = SpectralGate(threshold=0.0, device="cpu")(torch.as_tensor(x[0]))
    np.testing.assert_allclose(got.numpy(), x[0], rtol=0, atol=5e-4)


def test_spectral_gate_from_reference_params(rng):
    x = torch.as_tensor(rng.standard_normal((2, 5000)), dtype=torch.float32)
    ref = JaxGate(512, 128, 0.2)
    params = convert.gate_params_from_reference(
        np.asarray(ref.stft_plan.win, np.float64))
    a = SpectralGate(512, 128, 0.2, params=params, device="cpu")(x)
    b = SpectralGate(512, 128, 0.2, device="cpu")(x)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        convert.gate_params_from_reference(np.zeros((2, 512)))


@pytest.mark.parametrize("lifter", [0.0, 22.0])
def test_mfcc_frontend_matches_jax(rng, lifter):
    x = rng.standard_normal((2, 16000)).astype(np.float32)
    want = np.asarray(JaxFrontend(lifter=lifter)(jnp.asarray(x)))
    front = MFCCFrontend(lifter=lifter, device="cpu")
    got = front(torch.as_tensor(x))
    assert got.shape == want.shape == (2, 60, 13)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-4)
    params = convert.frontend_params_from_reference(
        get_window_np("hann", 1024, None),
        jmel.mel_filterbank_np(1024, 26, 16000.0, 0.0, 8000.0, "htk"),
        _dct2_matrix(26)[:13] * jmel._lifter_np(13, lifter)[:, None])
    got_ref = MFCCFrontend(lifter=lifter, params=params, device="cpu")(
        torch.as_tensor(x))
    torch.testing.assert_close(got_ref, got, rtol=0, atol=0)


def test_mel_energies_and_power_entries_match_jax(rng):
    x = rng.standard_normal((2, 12000)).astype(np.float32)
    want = jmel.mel_energies_stft(jnp.asarray(x), 512, 128, 40, 16000.0)
    got = tmel.mel_energies_stft(torch.as_tensor(x), 512, 128, 40, 16000.0)
    assert got.shape == want.shape
    assert _rel(got, want) < 5e-5
    want = jax_power_os(jnp.asarray(x), 1024, 256)
    got = power_spectrogram_onesided(torch.as_tensor(x), 1024, 256)
    assert _rel(got, want) < 5e-5
    want = JaxSTFT(1024, 256).power(jnp.asarray(x.reshape(2, 1, -1)))
    got = STFT(1024, 256).power(torch.as_tensor(x.reshape(2, 1, -1)))
    assert got.shape == want.shape and _rel(got, want) < 5e-5


@pytest.mark.parametrize("rfft", [True, False])
def test_stft_roundtrip_matches_jax(rng, rfft):
    nfft, hop, n = 1024, 256, 9000
    x = rng.standard_normal((2, n)).astype(np.float32)
    jplan, plan = JaxSTFT(nfft, hop), STFT(nfft, hop)
    want = jplan.reconstruct(jplan.process(jnp.asarray(x), rfft=rfft), n,
                             rfft=rfft)
    got = plan.reconstruct(plan.process(torch.as_tensor(x), rfft=rfft), n,
                           rfft=rfft)
    assert _interior_err(got, want, nfft) < 5e-6
    np.testing.assert_allclose(got.numpy()[:, nfft - hop:hop - nfft],
                               x[:, nfft - hop:hop - nfft], rtol=0, atol=3e-5)
    # leading axes fold like process's
    spec = plan.process(torch.as_tensor(x.reshape(2, 1, n)), rfft=rfft)
    folded = plan.reconstruct(spec, n, rfft=rfft)
    assert folded.shape == (2, 1, n)
    torch.testing.assert_close(folded[:, 0], got, rtol=0, atol=0)


def test_packed_roundtrip_and_interop(rng):
    """process_packed -> reconstruct_packed against the JAX XLA reference;
    to_natural against process(); a half-band apply_mask against masking
    the natural spectrum (tests/test_pallas_fft.py's packed-spectrum
    pattern)."""
    nfft, hop, nf = 512, 128, 40
    n = (nf - 1) * hop + nfft
    x = rng.standard_normal((2, n)).astype(np.float32)
    jplan, plan = JaxSTFT(nfft, hop), STFT(nfft, hop)
    spec = jplan._process_xla(jnp.asarray(x), True)
    ps = plan.process_packed(torch.as_tensor(x))
    # the frame count includes the zero-padded tail frame
    assert ps.nf == nf + 1 and ps.spec.shape == (2, nf + 1, nfft // 2 + 1)
    scale = max(1.0, float(jnp.abs(spec).max()))
    assert np.abs(ps.to_natural().numpy() - np.asarray(spec)).max() / scale \
        < 5e-6
    full = np.asarray(jplan._process_xla(jnp.asarray(x), False))
    assert np.abs(ps.to_natural(onesided=False).numpy() - full).max() \
        / scale < 5e-6
    np.testing.assert_allclose(ps.power_rows.numpy(),
                               np.abs(ps.spec.numpy()) ** 2, rtol=1e-6,
                               atol=1e-6 * scale ** 2)

    lo, hi = nfft, n - nfft
    ref = np.asarray(jplan._ola_norm(jfft.irfft(spec, nfft), n))
    got = plan.reconstruct_packed(ps, n).numpy()
    assert np.abs(got[:, lo:hi] - ref[:, lo:hi]).max() / max(
        1.0, np.abs(ref).max()) < 5e-6
    mask = np.zeros(nfft // 2 + 1, np.float32)
    mask[:nfft // 8] = 1.0
    got_m = plan.reconstruct_packed(ps.apply_mask(mask), n).numpy()
    ref_m = np.asarray(jplan._ola_norm(
        jfft.irfft(spec * jnp.asarray(mask), nfft), n))
    assert np.abs(got_m[:, lo:hi] - ref_m[:, lo:hi]).max() / max(
        1.0, np.abs(ref_m).max()) < 5e-6
    rows = ps.bin_to_row()
    np.testing.assert_array_equal(rows, np.arange(nfft // 2 + 1))
    with pytest.raises(ValueError):
        ps.apply_mask(np.ones(nfft // 2))
    with pytest.raises(ValueError):
        STFT(1024, 256).reconstruct_packed(ps, n)
    with pytest.raises(ValueError):
        plan.process_packed(torch.as_tensor(x[0]))


def test_packed_roundtrip_differentiates_through_the_mask(rng):
    nfft, hop, n = 512, 128, 3000
    x = torch.as_tensor(rng.standard_normal((1, n)), dtype=torch.float32)
    plan = STFT(nfft, hop)
    mask = torch.ones(nfft // 2 + 1, requires_grad=True)
    y = plan.reconstruct_packed(plan.process_packed(x).apply_mask(mask), n)
    (g,) = torch.autograd.grad(y.sum(), mask)
    assert g.shape == mask.shape and torch.isfinite(g).all()
    assert g.abs().max() > 0


def test_ola_norm_np_equals_jax_table():
    """Every packed-supported geometry, at the frames' cover, short of it
    and beyond it."""
    checked = 0
    for nfft in (256, 512, 1024, 2048, 4096):
        for hop in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
            if not jpf.stft_mel_packed_supported(nfft, hop):
                continue
            w = get_window_np("hann", nfft, None)
            nf = 7
            cover = (nf - 1) * hop + nfft
            for out_len in (cover, cover - hop - 3, cover + nfft + 5):
                want = jpf._ola_norm_table(nfft, hop, nf, out_len, "hann",
                                           None)
                got = tik.ola_norm_np(w, hop, nf, out_len)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)
            checked += 1
    assert checked >= 20


def test_inverse_fft_wrappers_and_ola_norm_match_jax(rng):
    from vv_dsp_tpu_torch.ops import fft as tfft
    z = (rng.standard_normal((3, 64)) + 1j * rng.standard_normal((3, 64))
         ).astype(np.complex64)
    assert _rel(tfft.ifft(torch.as_tensor(z)), jfft.ifft(jnp.asarray(z))) \
        < 1e-6
    assert _rel(tfft.irfft(torch.as_tensor(z[:, :33]), 64),
                jfft.irfft(jnp.asarray(z[:, :33]), 64)) < 1e-6
    time = rng.standard_normal((2, 20, 512)).astype(np.float32)
    want = JaxSTFT(512, 128)._ola_norm(jnp.asarray(time), 3000)
    got = STFT(512, 128)._ola_norm(torch.as_tensor(time), 3000)
    assert got.shape == (2, 3000)
    assert _interior_err(got, want, 512) < 5e-6


def test_overlap_add_forms_agree(rng):
    frames = torch.as_tensor(rng.standard_normal((2, 9, 64)))
    for out_len in (9 * 16 + 48, 100, 400):
        a = tfr.overlap_add_strided(frames, 16, out_len)
        b = tfr.overlap_add(frames, 16, out_len)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
        assert a.shape == (2, out_len)
    with pytest.raises(ValueError):
        tfr.overlap_add_strided(frames, 24, 100)
    # hop not dividing the frame: the general form against a loop
    got = tfr.overlap_add(frames, 24, 260)
    want = torch.zeros(2, 9 * 24 + 64)
    for f in range(9):
        want[:, f * 24:f * 24 + 64] += frames[:, f].float()
    torch.testing.assert_close(got.float(), want[:, :260], rtol=0, atol=1e-6)


def test_reconstruct_off_the_kernel_lattice_on_cpu(rng):
    """hop not dividing nfft runs the plain version on a CPU tensor."""
    x = rng.standard_normal((2, 6000)).astype(np.float32)
    jplan, plan = JaxSTFT(1000, 300), STFT(1000, 300)
    want = jplan.reconstruct(jplan.process(jnp.asarray(x), rfft=True), 6000,
                             rfft=True)
    got = plan.reconstruct(plan.process(torch.as_tensor(x), rfft=True), 6000,
                           rfft=True)
    assert _interior_err(got, want, 1000) < 5e-6


def test_dc_and_nyquist_imaginary_parts_are_ignored(rng):
    x = torch.as_tensor(rng.standard_normal((1, 4000)), dtype=torch.float32)
    plan = STFT(512, 128)
    spec = plan.process(x, rfft=True)
    bent = spec.clone()
    bent[..., 0] += 1j
    bent[..., -1] -= 2j
    torch.testing.assert_close(plan.reconstruct(bent, 4000, rfft=True),
                               plan.reconstruct(spec, 4000, rfft=True),
                               rtol=0, atol=0)


def test_reconstruct_gradient_matches_jax(rng):
    """The gradient of reconstruct (the plain version's, through the
    kernel shim) in the real and imaginary parts of the spectrum."""
    nfft, hop, n = 256, 64, 1200
    nf = 1 + (n - nfft + hop) // hop
    re = rng.standard_normal((1, nf, nfft // 2 + 1)).astype(np.float32)
    im = rng.standard_normal((1, nf, nfft // 2 + 1)).astype(np.float32)
    cot = rng.standard_normal((1, n)).astype(np.float32)
    jplan = JaxSTFT(nfft, hop)

    def jf(a, b):
        y = jplan.reconstruct(jax.lax.complex(a, b), n, rfft=True)
        return jnp.sum(y * cot)

    want = jax.grad(jf, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
    a = torch.as_tensor(re).requires_grad_(True)
    b = torch.as_tensor(im).requires_grad_(True)
    y = STFT(nfft, hop).reconstruct(torch.complex(a, b), n, rfft=True)
    got = torch.autograd.grad((y * torch.as_tensor(cot)).sum(), (a, b))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g, w) < 1e-5


def test_entry_modules_build_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (SpectralGate, MFCCFrontend):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
        with pytest.raises(ValueError, match="buffers on cpu"):
            cls(device="cpu")(torch.zeros(1, 4000, device="meta"))


def test_istft_wrapper_refuses_other_devices():
    spec = torch.zeros(1, 4, 513, dtype=torch.complex64, device="meta")
    w = torch.zeros(1024, device="meta")
    with pytest.raises(ValueError):
        tik.istft(spec, 1024, 256, 1792, w, torch.zeros(1792, device="meta"))
    with pytest.raises(ValueError):
        tsk.stft_power(torch.zeros(1, 4096, device="meta"), 1024, 256, w)
    assert tik.istft_supported(1024, 256) and tik.istft_supported(4096, 4096)
    assert not tik.istft_supported(1024, 384)
    assert not tik.istft_supported(128, 32)
