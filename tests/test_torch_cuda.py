"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and at the edges of each kernel's geometry (ratios whose
phases differ within a thread, short and ragged signals, every tier, both
spectrum forms, mel energies, the power spectrogram, and the inverse STFT
at q = nfft/hop = 1, 2, 4 and 8 with and without its gate). Needs an
NVIDIA GPU and nvcc; skips
without them. Run on the card (this file imports neither jax nor the JAX
package, so the suite's jax conftest is not needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances, as fractions of the plain version's max |value|: 1e-5 for
upfirdn (same products, another summation order); 5e-5 for the spectrum
and the mel energies (the FFT-class contract); f32 MFCCs 5e-4 absolute or
5e-6 of scale, whichever is larger (float32 FFT noise in the log of
low-energy mel bands, measured at 2.4e-6 of scale on the chain's shape).

At the bf16x3 and bf16 tiers the two versions' float32 powers differ by FFT
noise, so a tier rounding may land one step apart: u = 2^-15 (bf16x3) or
2^-7 (bf16) of a product, so 2u of each mel energy covers it. The MFCC
kernel's log and DCT are then held to the plain DCT step at the tier,
applied to the kernel's own mel energies: the same operands, so only the
float32 summation order differs, bounded per element by 2 k 2^-24 times
sum_b |dct[q, b] log mel_b| for k products per element.

The inverse kernel is held to its plain version fed the same spectrum:
5e-6 of the plain version's max |value| before the norm is divided out
(after it, the 1/w^2 norm amplifies float32 rounding without bound where
the frames' cover thins out). The gate compares squared magnitudes with no
fused multiply-add in both, so both keep the same bins.

Which tier a kernel computed is checked on the tier probes (inputs on which
both versions form the same products at one tier), where every other tier
must land beyond the limit; chip_smoke.py runs the same probes at the main
path's shapes.
"""

import numpy as np
import pytest
import torch

from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.models import MFCCFrontend, NorthStarChain, SpectralGate
from vv_dsp_tpu_torch.ops import istft_kernels as tik
from vv_dsp_tpu_torch.ops import mel as tmel
from vv_dsp_tpu_torch.ops import resample as trs
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops import upfirdn as tuf
from vv_dsp_tpu_torch.ops.stft import STFT
from vv_dsp_tpu_torch.ops.window import get_window_np

pytestmark = pytest.mark.cuda
ALGORITHMS = ("f32", "bf16x3", "bf16")
# the tier probes' limits (chip_smoke.py's; the MFCC probe's is 2.5e-6
# there, where 16 channels of 1246 frames reach further into both tails)
UPFIRDN_PROBE_TOL = 2.5e-7
MFCC_PROBE_TOL = 5e-7


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def gen():
    return np.random.default_rng(7)


def _rel(got, want):
    got, want = got.cpu().double(), want.cpu().double()
    return ((got - want).abs().max() / want.abs().max()).item()


def _cplx_rel(got, want):
    return _rel(torch.view_as_real(got), torch.view_as_real(want))


@pytest.mark.parametrize("up,down", [(4, 3), (7, 5), (2, 1), (1, 2), (3, 4)])
@pytest.mark.parametrize("algorithm", ["f32", "bf16x3", "bf16"])
def test_upfirdn_kernel_matches_plain(dev, gen, up, down, algorithm):
    h = trs._resample_poly_filter(up, down)
    off = (len(h) - 1) // 2
    x = torch.as_tensor(gen.standard_normal((3, 5001)), dtype=torch.float32,
                        device=dev)
    n_out = -(-5001 * up // down)
    taps = tuf.polyphase_table(h, up, dev)
    before = tuf.upfirdn_banded.launches
    got = tuf.upfirdn_banded(x, taps, up, down, off, n_out, algorithm)
    torch.cuda.synchronize()
    assert tuf.upfirdn_banded.launches == before + 1
    want = tuf.upfirdn_tall(x, taps, up, down, off, n_out, algorithm)
    assert got.shape == (3, n_out)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("n", [1, 40, 700, 24000])
def test_fused_head_kernel_matches_plain(dev, gen, n):
    h = NorthStarChain(device=dev).fir_coeffs.astype(np.float64)
    g, off = trs._fused_fir_resample_filter(tuple(h), 4, 3)
    x = torch.as_tensor(gen.standard_normal((2, n)), dtype=torch.float32,
                        device=dev)
    n_out = -(-n * 4 // 3)
    taps = tuf.polyphase_table(g, 4, dev)
    got = tuf.upfirdn_banded(x, taps, 4, 3, off, n_out, "bf16x3")
    want = tuf.upfirdn_tall(x, taps, 4, 3, off, n_out, "bf16x3")
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("nfft,hop", [(256, 64), (1024, 256), (2048, 512),
                                      (2048, 300), (4096, 1024)])
@pytest.mark.parametrize("n", [1000, 9001])
@pytest.mark.parametrize("onesided", [False, True])
def test_spectrum_kernel_matches_plain(dev, gen, nfft, hop, n, onesided):
    x = torch.as_tensor(gen.standard_normal((2, n)), dtype=torch.float32,
                        device=dev)
    win = STFT(nfft, hop).win(dev)
    got = tsk.stft_spectrum(x, nfft, hop, win, onesided)
    want = tsk.stft_spectrum_plain(x, nfft, hop, win, onesided)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert _cplx_rel(got, want) < 5e-5


@pytest.mark.parametrize("nfft,hop,n_mels,n_mfcc,sr,lifter", [
    (2048, 512, 80, 20, 64000.0, 0.0), (512, 128, 26, 13, 16000.0, 22.0),
    (4096, 1000, 64, 30, 48000.0, 0.0)])
@pytest.mark.parametrize("algorithm", ["f32", "bf16x3", "bf16"])
def test_mfcc_kernel_matches_plain(dev, gen, nfft, hop, n_mels, n_mfcc, sr,
                                   lifter, algorithm):
    x = torch.as_tensor(gen.standard_normal((2, 24001)), dtype=torch.float32,
                        device=dev)
    win, fb, bands, dct = tmel._mfcc_constants(nfft, n_mels, n_mfcc, sr, 0.0,
                                               sr / 2, lifter, "htk", "hann",
                                               None, dev)
    u = {"f32": 0.0, "bf16x3": 2.0 ** -15, "bf16": 2.0 ** -7}[algorithm]
    mel = tsk.stft_mfcc(x, nfft, hop, win, fb, bands, None, 1e-10, algorithm)
    mel_want = tsk.stft_mfcc_plain(x, nfft, hop, win, fb, None, 1e-10,
                                   algorithm)
    nf = mel_want.shape[1]
    assert mel.shape == (2, nf, n_mels)
    assert ((mel - mel_want).abs() <= 5e-5 * mel_want.abs().max()
            + 2 * u * mel_want.abs()).all()
    got = tsk.stft_mfcc(x, nfft, hop, win, fb, bands, dct, 1e-10, algorithm)
    assert got.shape == (2, nf, n_mfcc)
    if algorithm == "f32":
        want = tsk.stft_mfcc_plain(x, nfft, hop, win, fb, dct, 1e-10, "f32")
        err = (got - want).abs().max().item()
        assert err < max(5e-4, 5e-6 * want.abs().max().item())
    log_mel = torch.log(mel + 1e-10)
    step = config.tier_matmul(log_mel, dct.T, algorithm)
    k = n_mels * (3 if algorithm == "bf16x3" else 1)
    bound = 2 * k * 2.0 ** -24 * (log_mel.abs() @ dct.abs().T)
    assert ((got - step).abs() <= bound).all()


def test_chain_on_card_matches_cpu(dev, gen):
    x = torch.as_tensor(gen.standard_normal((2, 24000)), dtype=torch.float32)
    chain = NorthStarChain(device="cpu")
    want = chain(x)
    counts = [f.launches for f in (tuf.upfirdn_banded, tsk.stft_mfcc)]
    got = chain.to(dev)(x.to(dev))
    torch.cuda.synchronize()
    assert [f.launches for f in (tuf.upfirdn_banded, tsk.stft_mfcc)] == [
        c + 1 for c in counts]
    assert _rel(got, want) < 5e-5


def test_stft_process_on_card_matches_cpu(dev, gen):
    x = torch.as_tensor(gen.standard_normal((2, 30000)), dtype=torch.float32)
    for rfft in (False, True):
        before = tsk.stft_spectrum.launches
        got = STFT(1024, 256).process(x.to(dev), rfft=rfft)
        assert tsk.stft_spectrum.launches == before + 1
        assert _cplx_rel(got, STFT(1024, 256).process(x, rfft=rfft)) < 5e-5


def test_chain_gradient_on_card(dev, gen):
    """Backward runs the plain versions on the card: it matches the CPU."""
    x = torch.as_tensor(gen.standard_normal((1, 12000)), dtype=torch.float32)
    grads = []
    for d in ("cpu", dev):
        xt = x.detach().to(d).requires_grad_(True)
        NorthStarChain(head_algorithm="f32", stft_algorithm="f32",
                       device=d)(xt).sum().backward()
        grads.append(xt.grad)
    assert _rel(grads[1], grads[0]) < 1e-4


def test_wrappers_refuse_bad_tensors(dev):
    taps = torch.zeros(4, 1044, device=dev)
    x = torch.zeros(2, 2000, device=dev)
    with pytest.raises(TypeError):
        tuf.upfirdn_banded(x.double(), taps, 4, 3, 40, 2666)
    with pytest.raises(ValueError):
        tuf.upfirdn_banded(x[:, ::2], taps, 4, 3, 40, 1333)
    with pytest.raises(ValueError):
        tuf.upfirdn_banded(x, taps.cpu(), 4, 3, 40, 2666)
    with pytest.raises(ValueError):
        tsk.stft_spectrum(x, 1000, 250, torch.zeros(1000, device=dev))


def _impulses(shape, period, first, gen, dev):
    """Zeros with N(0, 1) impulses at first + i*period."""
    x = np.zeros(shape, np.float32)
    pos = np.arange(first, shape[-1], period)
    x[..., pos] = gen.standard_normal(shape[:-1] + (len(pos),))
    return torch.as_tensor(x, device=dev)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_upfirdn_tier_probe(dev, gen, algorithm):
    """One impulse per 1500 samples, more than a phase's 1044 taps: every
    output is one product at the tier, so the kernel matches the plain
    version at its own tier to a rounding and lands away from the others."""
    h = NorthStarChain(device=dev).fir_coeffs.astype(np.float64)
    g, off = trs._fused_fir_resample_filter(tuple(h), 4, 3)
    taps = tuf.polyphase_table(g, 4, dev)
    x = _impulses((2, 24000), 1500, 700, gen, dev)
    got = tuf.upfirdn_banded(x, taps, 4, 3, off, 32000, algorithm)
    for other in ALGORITHMS:
        err = _rel(got, tuf.upfirdn_tall(x, taps, 4, 3, off, 32000, other))
        assert (err < UPFIRDN_PROBE_TOL) == (other == algorithm), other


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_mfcc_tier_probe(dev, gen, algorithm):
    """One impulse per 2048 samples: every 2048-sample frame holds one and
    has a flat power spectrum, so FFT noise stays relative to every bin and
    the kernel matches the plain version at its own tier, per element
    within MFCC_PROBE_TOL of sum_b |dct[q, b]| (|log mel_b| + 1), and lands
    away from the other tiers."""
    win, fb, bands, dct = tmel._mfcc_constants(2048, 80, 20, 64000.0, 0.0,
                                               32000.0, 0.0, "htk", "hann",
                                               None, dev)
    x = _impulses((2, 40960), 2048, 1024, gen, dev)
    mel = tsk.stft_mfcc_plain(x, 2048, 512, win, fb, None, 1e-10, "f32")
    scale = (torch.log(mel + 1e-10).abs() + 1) @ dct.abs().T
    got = tsk.stft_mfcc(x, 2048, 512, win, fb, bands, dct, 1e-10, algorithm)
    for other in ALGORITHMS:
        want = tsk.stft_mfcc_plain(x, 2048, 512, win, fb, dct, 1e-10, other)
        err = ((got - want).abs() / scale).max().item()
        assert (err < MFCC_PROBE_TOL) == (other == algorithm), other


def test_unsupported_geometry_raises_on_card(dev, gen):
    """On a CUDA tensor the entry points launch the kernel or raise; none
    falls back to the plain version."""
    x = torch.as_tensor(gen.standard_normal((2, 30000)), dtype=torch.float32,
                        device=dev)
    for nfft, hop in ((128, 32), (1000, 250), (8192, 2048)):
        with pytest.raises(ValueError):
            STFT(nfft, hop).process(x)
    with pytest.raises(ValueError):
        tmel.mfcc_stft(x, 128, 32, 20, 13, 16000.0)
    with pytest.raises(ValueError):
        tmel.mfcc_stft(x, 8192, 2048, 80, 20, 64000.0)
    with pytest.raises(TypeError):
        STFT(1024, 256).process(x.to(torch.complex64))
    long_h = np.full(40_000, 1 / 40_000)   # (4, 40020) taps: no block holds it
    with pytest.raises(RuntimeError):
        trs.fir_resample_fused(long_h, x, 4, 3)
    # the refused launch leaves no error behind for the next one
    h = NorthStarChain(device=dev).fir_coeffs
    assert trs.fir_resample_fused(h, x, 4, 3).shape == (2, 40000)


@pytest.mark.parametrize("nfft,hop", [(256, 64), (1024, 256), (2048, 300),
                                      (4096, 1024)])
@pytest.mark.parametrize("n", [700, 9001])
def test_power_kernel_matches_plain(dev, gen, nfft, hop, n):
    x = torch.as_tensor(gen.standard_normal((2, n)), dtype=torch.float32,
                        device=dev)
    win = STFT(nfft, hop).win(dev)
    before = tsk.stft_power.launches
    got = tsk.stft_power(x, nfft, hop, win)
    torch.cuda.synchronize()
    assert tsk.stft_power.launches == before + 1
    want = tsk.stft_power_plain(x, nfft, hop, win)
    assert got.shape == want.shape == (2, want.shape[1], nfft // 2 + 1)
    assert _rel(got, want) < 5e-5


@pytest.mark.parametrize("nfft,hop", [(256, 256), (256, 64), (1024, 512),
                                      (1024, 256), (1024, 128),
                                      (4096, 1024), (4096, 512)])
@pytest.mark.parametrize("n", [700, 9001])
def test_istft_kernel_matches_plain(dev, gen, nfft, hop, n):
    """q = nfft/hop in {1, 2, 4, 8}; n < nfft; output_len at, short of and
    beyond the frames' cover; no gate and gates at 0, 0.1 and 1; the same
    bits on a second run."""
    x = torch.as_tensor(gen.standard_normal((2, n)), dtype=torch.float32,
                        device=dev)
    win = STFT(nfft, hop).win(dev)
    spec = tsk.stft_spectrum(x, nfft, hop, win, onesided=True)
    nf = spec.shape[1]
    cover = (nf - 1) * hop + nfft
    for out_len in (cover, max(cover - hop - 5, nfft // 2),
                    cover + 2 * nfft + 3):
        norm = tik.ola_norm(get_window_np("hann", nfft), hop, nf, out_len,
                            dev)
        for gate in (None, 0.0, 0.1, 1.0):
            before = tik.istft.launches
            got = tik.istft(spec, nfft, hop, out_len, win, norm, gate)
            again = tik.istft(spec, nfft, hop, out_len, win, norm, gate)
            torch.cuda.synchronize()
            assert tik.istft.launches == before + 2
            want = tik.istft_plain(spec, nfft, hop, out_len, win, norm, gate)
            assert got.shape == (2, out_len)
            assert torch.equal(got, again)
            assert _rel(got * norm, want * norm) < 5e-6, (out_len, gate)
            if out_len > cover:
                assert (got[:, cover:] == 0).all()


def test_istft_gate_one_keeps_only_the_peaks(dev, gen):
    x = torch.as_tensor(gen.standard_normal((1, 6000)), dtype=torch.float32,
                        device=dev)
    win = STFT(512, 128).win(dev)
    spec = tsk.stft_spectrum(x, 512, 128, win, onesided=True)
    p2 = spec.real * spec.real + spec.imag * spec.imag
    peaks = torch.where(p2 == p2.amax(-1, keepdim=True), spec,
                        torch.zeros_like(spec))
    norm = tik.ola_norm(get_window_np("hann", 512), 128, spec.shape[1], 6000,
                        dev)
    got = tik.istft(spec, 512, 128, 6000, win, norm, 1.0)
    want = tik.istft_plain(peaks, 512, 128, 6000, win, norm)
    assert _rel(got * norm, want * norm) < 5e-6


def test_synthesis_entry_points_on_card_match_cpu(dev):
    """SpectralGate, reconstruct, the packed roundtrip, power and
    MFCCFrontend through the kernels, against the CPU (seed 1: no bin
    within 1e-4 of the gate's threshold)."""
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 8192)),
                        dtype=torch.float32)
    xd = x.to(dev)
    names = ("stft_spectrum", "stft_power", "stft_mfcc")
    counts = [getattr(tsk, f).launches for f in names] + [tik.istft.launches]
    got = SpectralGate(device=dev)(xd)
    want = SpectralGate(device="cpu")(x)
    assert _rel(got, want) < 5e-6
    plan = STFT(1024, 256)
    got = plan.reconstruct(plan.process(xd, rfft=True), 8192, rfft=True)
    want = plan.reconstruct(plan.process(x, rfft=True), 8192, rfft=True)
    assert _rel(got[:, 1024:-1024], want[:, 1024:-1024]) < 5e-6
    ps = plan.process_packed(xd).apply_mask(np.ones(513))
    assert _rel(plan.reconstruct_packed(ps, 8192)[:, 1024:-1024],
                want[:, 1024:-1024]) < 5e-6
    assert _rel(plan.power(xd), plan.power(x)) < 5e-5
    front = MFCCFrontend(device=dev)
    err = (front(xd).cpu() - MFCCFrontend(device="cpu")(x)).abs().max()
    assert err.item() < 5e-4
    torch.cuda.synchronize()
    after = [getattr(tsk, f).launches for f in names] + [tik.istft.launches]
    # spectrum: the gate, process and process_packed; istft: the gate and
    # both roundtrips
    assert [a - b for a, b in zip(after, counts)] == [3, 1, 1, 3]


def test_synthesis_refuses_what_the_kernels_do_not_take(dev, gen):
    x = torch.as_tensor(gen.standard_normal((2, 9000)), dtype=torch.float32,
                        device=dev)
    with pytest.raises(ValueError):
        SpectralGate(1024, 384, device=dev)(x)
    plan = STFT(1024, 384)
    spec = plan.process(x, rfft=True)        # the forward kernel takes it
    with pytest.raises(ValueError):
        plan.reconstruct(spec, 9000, rfft=True)
    with pytest.raises(ValueError):
        STFT(128, 32).power(x)
    with pytest.raises(TypeError):
        tik.istft(torch.zeros(2, 5, 513, dtype=torch.complex128, device=dev),
                  1024, 256, 2048, STFT(1024, 256).win(dev),
                  torch.ones(2048, device=dev))
    with pytest.raises(ValueError):
        SpectralGate(device=dev)(x.cpu())
