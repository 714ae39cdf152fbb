"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes and at the edges of each kernel's geometry (ratios whose
phases differ within a thread, short and ragged signals, every tier, both
spectrum forms, mel energies, the power spectrogram, and the inverse STFT
at q = nfft/hop = 1, 2, 4 and 8 with and without its gate, and the
full-nfft kernels at nfft = 128 and hop = 8: short signals, one frame,
hop == nfft, q = 128, one channel, bit-identical reruns of the fused gate,
and the fused gate and mel/MFCC kernel on the register-resident FFT at
every transform size, at hop 8 (16 at 2048) and nfft/4, with their
launchers' refusal of a plan size not their own;
the direct FIR and the per-phase resampler at taps 1 to 2048, n < taps and
every ratio class, with bit-identical reruns, and the banded kernel at the
filter and resample entry points' geometries; the fused head's staged
tail written into the kernel's buffer (no second output buffer, no cat);
the windowed-DFT power at
hop | nfft, 128 | hop, n < nfft and extra frames; the per-phase
resampler at all 377 ratios it takes and one of each of its instances;
every kernel wrapper at 65,536 rows (two launches); ``fir_apply_best``
with taps on the card at the ``fir1024.batch64`` cell's shape (no copy
from the card after the first call on the overlap-save route and on the
banded one at bf16x3, the host taps' bits, the cell's limit, the
overlap-save route counted once a call); the overlap-save FIR kernel
against its plain version at the cell's shape, at taps 1 to 2,048, n from
1 through one segment either side of a multiple of its block, and on an
unaligned row, and its refusals; the full-nfft inverse
with all nfft bins of a non-Hermitian spectrum and with the one-sided
half, at q = 1 to 128; the packed fused gate at threshold 0 and on the
tone probe, with bit-identical reruns; the packed inverse and fused gate
on the register-resident FFT at every transform size, the inverse to
q = 256 and the gate to q = 128, on short and ragged signals and at three
shared-memory sizes of one instance in one process, and their launchers'
refusal of a plan size not their own; the two register-resident spectrum
kernels at every transform size, 128 to 2048 points, on part groups of
frames, tails past the signal and a unit impulse, whose spectrum is known
to 1e-6 absolute; the two tensor-core kernels at every tier and launch
geometry, the chain's fused heads at 8/7, 5/7 and 2,048 FIR taps, a
16,384-tap FIR (B streamed in depth chunks) and 1/1000 (A's rows
copied), ragged and short signals, 1 and 65535 channels, the tier probe
at 1024 taps, and the windowed-DFT power at q = 1 to 129 (from q = 104
split over two sample tiles) and depths to 16,512, with fewer and more
frames than the signal holds and an unaligned signal; the two power
kernels on the register-resident FFT at every instance, odd frame counts
and hop == nfft, the full-nfft launcher's refusal of nfft < 128, and the
kernels' launch cache (csrc/fft_reg.cuh fr_launch) from two host threads
and from a second loaded copy of the library). Needs an
NVIDIA GPU and nvcc;
skips without them. Run on the card (this
file imports neither jax nor the JAX package, so the suite's jax conftest
is not needed):

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

import hashlib

import numpy as np
import pytest
import torch

from vv_dsp_tpu_torch import _build, config
from vv_dsp_tpu_torch.models import MFCCFrontend, NorthStarChain, SpectralGate
from vv_dsp_tpu_torch.ops import filter_kernels as tfk
from vv_dsp_tpu_torch.ops import istft_kernels as tik
from vv_dsp_tpu_torch.ops import mel as tmel
from vv_dsp_tpu_torch.ops import mma_plan as tmp
from vv_dsp_tpu_torch.ops import poly_plan as tpp
from vv_dsp_tpu_torch.ops import resample as trs
from vv_dsp_tpu_torch.ops import savgol as tsg
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops import stockham_kernels as tstk
from vv_dsp_tpu_torch.ops import upfirdn as tuf
from vv_dsp_tpu_torch.ops.fir import design_lowpass, design_lowpass_np
from vv_dsp_tpu_torch.ops.framing import stft_num_frames
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


def _gate_norm(nfft, hop, n, device):
    """SpectralGate's w^2 overlap-add norm on its output's n samples."""
    pad = nfft - hop
    return tik.ola_norm(get_window_np("hann", nfft), hop,
                        stft_num_frames(n + 2 * pad, nfft, hop), n + 2 * pad,
                        device)[pad:pad + n]


def _gate_rel(got, want, nfft, hop):
    """SpectralGate's outputs compared before the norm is divided out, as
    the inverse's pin holds them (after it, 1/w^2 amplifies float32
    rounding without bound where a frame's edge alone covers a sample)."""
    norm = _gate_norm(nfft, hop, want.shape[-1], "cpu")
    return _rel(got.cpu() * norm, want.cpu() * norm)


def _counters():
    """The 15 kernel wrappers, each counting its launches."""
    return (tuf.upfirdn_banded, tsk.stft_mfcc, tsk.stft_spectrum,
            tsk.stft_power, tik.istft, tstk.stft_power_stockham,
            tstk.stft_mel_stockham, tstk.stft_gate_stockham,
            tstk.stft_spectrum_stockham, tfk.fir_direct,
            tfk.resample_poly_kernel, tsk.stft_power_dft,
            tstk.istft_stockham, tik.stft_gate_packed, tfk.fir_os)


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


def test_fused_head_writes_its_tail_in_place_on_card(dev, gen):
    """At the chain's taps on (8, 479232) one fir_resample_fused call holds
    at most one output buffer more (+1 MB), runs no CatArrayBatchedCopy,
    counts one tail written in place, and matches the CPU path."""
    h = NorthStarChain(device="cpu").fir_coeffs
    x_cpu = torch.as_tensor(gen.standard_normal((8, 479_232)),
                            dtype=torch.float32)
    x = x_cpu.to(dev)
    run = lambda: trs.fir_resample_fused(h, x, 4, 3, algorithm="bf16x3")
    run()   # the plan, B's parts and the tail's weights are cached
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = trs.fir_resample_fused.tails_in_place
    got = run()
    torch.cuda.synchronize()
    assert trs.fir_resample_fused.tails_in_place == before + 1
    assert (torch.cuda.max_memory_allocated(dev) - base
            <= got.numel() * got.element_size() + 2**20)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("upfirdn_mma_kernel" in k for k in names)
    assert not any("CatArrayBatchedCopy" in k for k in names)
    want = trs.fir_resample_fused(h, x_cpu, 4, 3, algorithm="bf16x3")
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("nfft,hop", [(256, 64), (512, 128), (1024, 256),
                                      (1024, 255), (1024, 1024), (2048, 512),
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


def _sha256(t):
    """The sha256 of a tensor's bytes, on the host."""
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("nfft,hop,channels,n,pad", [
    (1024, 256, 64, 479232, 768),   # SpectralGate's cell
    (2048, 512, 3, 30011, 1536),
    (1024, 256, 2, 9001, 333),      # odd: every frame takes scalar loads
    (1024, 256, 2, 700, 768),       # n < nfft
    (1024, 256, 2, 700, 5),
    (256, 64, 65537, 600, 192)])    # two runs of rows
@pytest.mark.parametrize("onesided", [False, True])
def test_spectrum_kernel_reads_its_pad_in_place(dev, gen, nfft, hop,
                                                channels, n, pad, onesided):
    """The kernel's lead instance on the unpadded rows is bit for bit the
    kernel on the rows zero-padded by F.pad, and counts its launches in
    stft_spectrum.edge_pads."""
    x = torch.as_tensor(gen.standard_normal((channels, n)),
                        dtype=torch.float32, device=dev)
    win = STFT(nfft, hop).win(dev)
    want = tsk.stft_spectrum(torch.nn.functional.pad(x, (pad, pad)), nfft,
                             hop, win, onesided)
    before = (tsk.stft_spectrum.launches, tsk.stft_spectrum.edge_pads)
    got = tsk.stft_spectrum(x, nfft, hop, win, onesided, pad=pad)
    torch.cuda.synchronize()
    runs = len(_build.row_chunks(channels))
    assert runs == (2 if channels > 65535 else 1)
    assert (tsk.stft_spectrum.launches, tsk.stft_spectrum.edge_pads) == (
        before[0] + runs, before[1] + runs)
    assert got.shape == want.shape
    assert _sha256(got) == _sha256(want)


def test_gate_on_card_is_the_padded_input_bit_for_bit(dev, gen):
    """SpectralGate at the gate cell's shape, its spectrum reading the edge
    pad in place, against the spectrum kernel on F.pad's padded copy and
    the gated inverse: the same bits. One edge-pad launch a gate call; the
    STFT's process and the chain launch none."""
    nfft, hop, n = 1024, 256, 479232
    pad = nfft - hop
    x = torch.as_tensor(gen.standard_normal((64, n)), dtype=torch.float32,
                        device=dev)
    gate = SpectralGate(nfft, hop, 0.1, device=dev)
    before = tsk.stft_spectrum.edge_pads
    got = gate(x)
    torch.cuda.synchronize()
    assert tsk.stft_spectrum.edge_pads == before + 1
    xp = torch.nn.functional.pad(x, (pad, pad))
    n_pad = xp.shape[-1]
    norm = tik.ola_norm(gate.window_np, hop,
                        stft_num_frames(n_pad, nfft, hop), n_pad, dev)
    spec = tsk.stft_spectrum(xp, nfft, hop, gate.window, True)
    want = tik.istft(spec, nfft, hop, n_pad, gate.window, norm, 0.1)
    assert _sha256(got) == _sha256(want[..., pad:pad + n])
    before = tsk.stft_spectrum.edge_pads
    STFT(nfft, hop).process(x[:2], rfft=True)
    NorthStarChain(device=dev)(x[:2, :48000])
    torch.cuda.synchronize()
    assert tsk.stft_spectrum.edge_pads == before


# the register-resident spectrum kernels (csrc/fft_reg.cuh) at every
# transform size N: the packed kernel at N = nfft/2, the full-nfft one at
# N = nfft
SPECTRUM_KERNELS = [("packed", nfft, hop) for nfft, hop in
                    ((256, 64), (512, 128), (1024, 256), (2048, 512),
                     (4096, 1024))] + [
    ("full", nfft, hop) for nfft, hop in
    ((128, 32), (256, 32), (512, 8), (1024, 8), (2048, 16))]


def _spectrum_kernel(kind):
    return (tsk.stft_spectrum, tsk.stft_spectrum_plain) if kind == "packed" \
        else (tstk.stft_spectrum_stockham, tstk.stft_spectrum_stockham_plain)


@pytest.mark.parametrize("kind,nfft,hop", SPECTRUM_KERNELS)
@pytest.mark.parametrize("channels", [1, 3])
def test_spectrum_kernels_on_part_groups_and_tails(dev, gen, kind, nfft, hop,
                                                   channels):
    """Frame counts that are not a multiple of a block's frames, and the
    frames that run past the signal (zero there), on 1 and 3 channels."""
    fast, plain = _spectrum_kernel(kind)
    # a packed block transforms 2048/m frames; a full-nfft block two real
    # frames in each of its 2048/nfft transforms
    per_block = 2048 // (nfft // 2) if kind == "packed" else 4096 // nfft
    n = 7 * nfft + 3 * hop + 5
    nf = stft_num_frames(n, nfft, hop)
    assert nf % per_block or per_block == 1
    x = torch.as_tensor(gen.standard_normal((channels, n)),
                        dtype=torch.float32, device=dev)
    win = STFT(nfft, hop).win(dev)
    for onesided in (False, True):
        before = fast.launches
        got = fast(x, nfft, hop, win, onesided)
        torch.cuda.synchronize()
        assert fast.launches == before + 1
        want = plain(x, nfft, hop, win, onesided)
        assert got.shape == want.shape == (channels, nf, want.shape[2])
        assert _cplx_rel(got, want) < 5e-5
        # the last frame reaches past the signal: its tail reads as zero
        assert _cplx_rel(got[:, -1], want[:, -1]) < 5e-5


@pytest.mark.parametrize("kind,nfft,hop", SPECTRUM_KERNELS)
@pytest.mark.parametrize("at", [1, 3, 0.5, -1])
def test_spectrum_kernels_on_an_impulse(dev, kind, nfft, hop, at):
    """A unit impulse at sample j of frame 0 is w[j] exp(-2 pi i k j / nfft)
    in every bin k: a wrong bin order or a lost twiddle shows here as an
    error of order 1, which a relative error on noise could blur."""
    j = int(at * nfft) if isinstance(at, float) else at % nfft
    fast, _ = _spectrum_kernel(kind)
    x = torch.zeros((2, 3 * nfft), dtype=torch.float32, device=dev)
    x[:, j] = 1.0
    win = STFT(nfft, hop).win(dev)
    w = float(win[j])
    k = np.arange(nfft)
    want = w * np.exp(-2j * np.pi * k * j / nfft)
    for onesided in (False, True):
        got = fast(x, nfft, hop, win, onesided)[:, 0].cpu().numpy()
        bins = nfft // 2 + 1 if onesided else nfft
        assert np.abs(got - want[:bins]).max() < 1e-6


def _check_mfcc(x, nfft, hop, win, fb, bands, dct, algorithm):
    """The MFCC kernel against its plain version at one tier: mel energies
    within 5e-5 of scale plus 2u of each value; f32 MFCCs within 5e-4
    absolute or 5e-6 of scale; the kernel's log and DCT within float32
    summation of the plain DCT step on its own mel energies. Returns the
    MFCCs."""
    n_mels, n_mfcc = dct.shape[1], dct.shape[0]
    u = {"f32": 0.0, "bf16x3": 2.0 ** -15, "bf16": 2.0 ** -7}[algorithm]
    mel = tsk.stft_mfcc(x, nfft, hop, win, fb, bands, None, 1e-10, algorithm)
    mel_want = tsk.stft_mfcc_plain(x, nfft, hop, win, fb, None, 1e-10,
                                   algorithm)
    nf = mel_want.shape[1]
    assert mel.shape == (x.shape[0], nf, n_mels)
    assert ((mel - mel_want).abs() <= 5e-5 * mel_want.abs().max()
            + 2 * u * mel_want.abs()).all()
    got = tsk.stft_mfcc(x, nfft, hop, win, fb, bands, dct, 1e-10, algorithm)
    assert got.shape == (x.shape[0], nf, n_mfcc)
    if algorithm == "f32":
        want = tsk.stft_mfcc_plain(x, nfft, hop, win, fb, dct, 1e-10, "f32")
        err = (got - want).abs().max().item()
        assert err < max(5e-4, 5e-6 * want.abs().max().item())
    log_mel = torch.log(mel + 1e-10)
    step = config.tier_matmul(log_mel, dct.T, algorithm)
    k = n_mels * (3 if algorithm == "bf16x3" else 1)
    bound = 2 * k * 2.0 ** -24 * (log_mel.abs() @ dct.abs().T)
    assert ((got - step).abs() <= bound).all()
    return got


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
    _check_mfcc(x, nfft, hop, win, fb, bands, dct, algorithm)


def _mfcc_setup(nfft, n_mels, n_mfcc, sr, dev):
    return tmel._mfcc_constants(nfft, n_mels, n_mfcc, sr, 0.0, sr / 2, 0.0,
                                "htk", "hann", None, dev)


@pytest.mark.parametrize("nfft,n_mels,n_mfcc,sr", [
    (256, 24, 12, 8000.0), (512, 40, 20, 16000.0), (1024, 26, 13, 16000.0),
    (2048, 80, 20, 64000.0), (4096, 64, 30, 48000.0)])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_mfcc_kernel_at_every_transform_size(dev, gen, nfft, n_mels, n_mfcc,
                                             sr, algorithm):
    """Every packed transform size (m = 128 to 2048 points) at each tier:
    a hop that divides neither nfft nor n, fewer frames than a block's
    group of 4096/nfft (one frame at 4096), one frame (n < nfft), one
    channel and three; and the same bits on a second run."""
    win, fb, bands, dct = _mfcc_setup(nfft, n_mels, n_mfcc, sr, dev)
    hop = nfft // 4 + 3
    for c, n in ((1, nfft - 7), (3, 2 * hop + nfft + 5), (2, 20 * hop + 1)):
        x = torch.as_tensor(gen.standard_normal((c, n)),
                            dtype=torch.float32, device=dev)
        got = _check_mfcc(x, nfft, hop, win, fb, bands, dct, algorithm)
        again = tsk.stft_mfcc(x, nfft, hop, win, fb, bands, dct, 1e-10,
                              algorithm)
        assert torch.equal(got, again)


def test_mfcc_kernel_launches_at_several_layout_sizes(dev, gen):
    """One process, one kernel instance (2048 points, f32, fused DCT) at
    three shared-memory sizes, the largest second: each launch within
    fr_launch's attribute and block count for its size."""
    x = torch.as_tensor(gen.standard_normal((2, 30001)), dtype=torch.float32,
                        device=dev)
    for n_mels, n_mfcc in ((40, 13), (128, 64), (80, 20)):
        win, fb, bands, dct = _mfcc_setup(2048, n_mels, n_mfcc, 64000.0, dev)
        _check_mfcc(x, 2048, 512, win, fb, bands, dct, "f32")


def test_mfcc_kernel_reads_tables_from_device_memory(dev, gen):
    """A DCT too large to stage (128 x 128 at 4096 points): the plan reads
    the filterbank and the DCT from device memory, at every tier."""
    from vv_dsp_tpu_torch.ops import fft_plan
    win, fb, bands, dct = _mfcc_setup(4096, 128, 128, 48000.0, dev)
    weights, _ = tsk._mel_tables(fb, bands)
    assert not fft_plan.mfcc_plan(4096, 128, 128, weights.numel(), True).staged
    x = torch.as_tensor(gen.standard_normal((2, 24001)), dtype=torch.float32,
                        device=dev)
    for algorithm in ALGORITHMS:
        _check_mfcc(x, 4096, 1024, win, fb, bands, dct, algorithm)


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
    """Where no kernel takes the geometry (the JAX package runs XLA there)
    the entry points take the "torch" route on the card, launch nothing
    and return the CPU result; a refusal inside a kernel's own lattice
    still raises."""
    x = torch.as_tensor(gen.standard_normal((2, 30000)), dtype=torch.float32,
                        device=dev)
    counters = _counters()
    before = [f.launches for f in counters]
    for nfft, hop in ((128, 24), (1000, 250), (8192, 2048)):
        assert _cplx_rel(STFT(nfft, hop).process(x),
                         STFT(nfft, hop).process(x.cpu())) < 5e-5
    for args in ((128, 24, 20, 13, 16000.0), (8192, 2048, 80, 20, 64000.0)):
        err = (tmel.mfcc_stft(x, *args).cpu()
               - tmel.mfcc_stft(x.cpu(), *args)).abs().max()
        assert err.item() < 5e-4
    z = x.to(torch.complex64)
    assert _cplx_rel(STFT(1024, 256).process(z),
                     STFT(1024, 256).process(z.cpu())) < 5e-5
    torch.cuda.synchronize()
    assert [f.launches for f in counters] == before
    h = NorthStarChain(device=dev).fir_coeffs
    g, off = trs._fused_fir_resample_filter(tuple(h), 4, 3)
    taps = tuf.polyphase_table(g, 4, dev)
    with pytest.raises(RuntimeError):             # the entry's refusal
        tuf.upfirdn_banded(x, taps, 4, 3, -1, 40000)
    # a head no block can hold whole (4 x 40,020 taps) streams its band in
    # depth chunks: it launches, and matches the plain version
    long_h = np.full(40_000, 1 / 40_000)
    before = tuf.upfirdn_banded.launches
    got = trs.fir_resample_fused(long_h, x, 4, 3, algorithm="f32")
    assert tuf.upfirdn_banded.launches == before + 1
    g, off = trs._fused_fir_resample_filter(tuple(long_h), 4, 3)
    want = tuf.upfirdn_tall(x, tuf.polyphase_table(g, 4, dev), 4, 3, off,
                            40000, "f32", group=8)
    assert _rel(got[:, :39000], want[:, :39000]) < 1e-5
    # the refused call leaves no error behind for the next one
    assert trs.fir_resample_fused(h, x, 4, 3).shape == (2, 40000)


def _odd_frames(nfft, hop):
    """A signal length of 2 FB + 1 frames (FB = 4096/nfft, the frames of a
    group of both power kernels), ragged: three groups, the last of one
    frame."""
    nf = 8192 // nfft + 1
    n = nfft + hop * (nf - 2) + 5
    assert stft_num_frames(n, nfft, hop) == nf
    return n


# the packed power kernel at every instance (M = nfft/2 = 128..2048), odd
# hops (the 8-byte load off an even float offset) and hop == nfft
@pytest.mark.parametrize("nfft,hop", [(256, 64), (256, 256), (512, 128),
                                      (1024, 256), (1024, 255), (1024, 1024),
                                      (2048, 300), (2048, 512), (4096, 1024),
                                      (4096, 4096)])
@pytest.mark.parametrize("n", [700, 9001, None])
def test_power_kernel_matches_plain(dev, gen, nfft, hop, n):
    """n < nfft at 1024 and up, a ragged tail, and (None) an odd frame
    count whose last group holds one frame."""
    n = n or _odd_frames(nfft, hop)
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
    """1024/384 (hop not dividing nfft): the forward kernel takes it, the
    inverse and the gate take the "torch" route, deterministic on the card;
    128/24 power too. Calls the wrappers refuse still raise."""
    x = torch.as_tensor(gen.standard_normal((2, 9000)), dtype=torch.float32,
                        device=dev)
    counters = _counters()
    before = [f.launches for f in counters]
    gate = SpectralGate(1024, 384, device=dev)(x)
    assert _gate_rel(gate, SpectralGate(1024, 384, device="cpu")(x.cpu()),
                     1024, 384) < 5e-6
    plan = STFT(1024, 384)
    spec = plan.process(x, rfft=True)        # the forward kernel takes it
    got = plan.reconstruct(spec, 9000, rfft=True)
    assert torch.equal(got, plan.reconstruct(spec, 9000, rfft=True))
    assert _rel(got[:, 1024:-1024], plan.reconstruct(
        spec.cpu(), 9000, rfft=True)[:, 1024:-1024]) < 5e-6
    assert _rel(STFT(128, 24).power(x), STFT(128, 24).power(x.cpu())) < 5e-5
    torch.cuda.synchronize()
    after = [f.launches for f in counters]
    # the forward call's one spectrum launch
    assert [a - b for a, b in zip(after, before)] == [
        1 if f is tsk.stft_spectrum else 0 for f in counters]
    with pytest.raises(TypeError):
        tik.istft(torch.zeros(2, 5, 513, dtype=torch.complex128, device=dev),
                  1024, 256, 2048, STFT(1024, 256).win(dev),
                  torch.ones(2048, device=dev))
    with pytest.raises(ValueError):
        SpectralGate(device=dev)(x.cpu())


# the full-nfft family: nfft = 128 at several hops (hop == nfft included),
# hop 8 up to q = 128 (1024/8)
STOCKHAM_GEOMETRIES = [(128, 32), (128, 8), (128, 128), (256, 8), (256, 32),
                       (512, 8), (1024, 8), (2048, 16), (2048, 2048)]


@pytest.mark.parametrize("nfft,hop", STOCKHAM_GEOMETRIES)
@pytest.mark.parametrize("channels,n", [(2, 100), (1, 3001), (3, 9000),
                                        (2, None)])
def test_stockham_spectrum_and_power_kernels_match_plain(dev, gen, nfft, hop,
                                                         channels, n):
    """n < nfft at 128 and beyond (one frame), ragged tails, and (None) an
    odd frame count, whose last pair's second frame lies past nf, at every
    transform size N = 128..2048."""
    n = n or _odd_frames(nfft, hop)
    x = torch.as_tensor(gen.standard_normal((channels, n)),
                        dtype=torch.float32, device=dev)
    win = STFT(nfft, hop).win(dev)
    for onesided in (False, True):
        before = tstk.stft_spectrum_stockham.launches
        got = tstk.stft_spectrum_stockham(x, nfft, hop, win, onesided)
        torch.cuda.synchronize()
        assert tstk.stft_spectrum_stockham.launches == before + 1
        want = tstk.stft_spectrum_stockham_plain(x, nfft, hop, win, onesided)
        assert got.shape == want.shape and got.dtype == torch.complex64
        assert _cplx_rel(got, want) < 5e-5
    before = tstk.stft_power_stockham.launches
    got = tstk.stft_power_stockham(x, nfft, hop, win)
    torch.cuda.synchronize()
    assert tstk.stft_power_stockham.launches == before + 1
    want = tstk.stft_power_stockham_plain(x, nfft, hop, win)
    assert got.shape == want.shape == (channels, want.shape[1],
                                       nfft // 2 + 1)
    assert _rel(got, want) < 5e-5


def test_stockham_power_launcher_refuses_nfft_below_128(dev):
    """vv_stockham_power takes fr_fft's N = 128..2048 only, as the other
    full-nfft launchers do, and launches nothing at nfft = 64 (or 4096)."""
    from vv_dsp_tpu_torch import _build
    from vv_dsp_tpu_torch.ops import fft_plan
    lib = _build.library()
    x = torch.zeros(1, 4096, device=dev)
    for nfft in (64, 4096):
        hop = nfft // 4
        nf = stft_num_frames(x.shape[1], nfft, hop)
        out = torch.full((1, nf, nfft // 2 + 1), 7.0, device=dev)
        win = torch.ones(nfft, device=dev)
        tw = fft_plan.pass_twiddles(128, dev)
        assert lib.vv_stockham_power(
            _build.ptr(x), _build.ptr(win), _build.ptr(tw), _build.ptr(out),
            1, x.shape[1], nf, nfft, hop, dev.index,
            _build.stream_handle(x)) != 0
        torch.cuda.synchronize()
        assert (out == 7.0).all()


# the full-nfft mel and gate kernels on fr_fft at every transform size, at
# hop 8 (16 at 2048, where 8 would make q = 256) and at nfft/4
FR_GEOMETRIES = [(128, 32), (128, 8), (256, 8), (256, 64), (512, 8),
                 (512, 128), (1024, 8), (1024, 256), (2048, 16), (2048, 512)]


@pytest.mark.parametrize("nfft,hop,n_mels,n_mfcc,sr,lifter", [
    (128, 32, 26, 13, 8000.0, 0.0), (128, 128, 20, 12, 8000.0, 22.0),
    (256, 8, 40, 13, 16000.0, 0.0), (1024, 8, 64, 20, 16000.0, 22.0),
    (128, 8, 26, 13, 8000.0, 22.0), (256, 64, 40, 13, 16000.0, 22.0),
    (512, 8, 40, 13, 16000.0, 0.0), (512, 128, 40, 13, 16000.0, 22.0),
    (1024, 256, 64, 20, 16000.0, 0.0), (2048, 16, 80, 20, 16000.0, 22.0),
    (2048, 512, 80, 20, 16000.0, 0.0)])
@pytest.mark.parametrize("channels,n", [(1, 90), (2, 9001)])
def test_stockham_mel_kernel_matches_plain(dev, gen, nfft, hop, n_mels,
                                           n_mfcc, sr, lifter, channels, n):
    """Mel energies and MFCCs on a signal shorter than one group of frames
    (one channel) and on a ragged one, each call one launch."""
    x = torch.as_tensor(gen.standard_normal((channels, n)),
                        dtype=torch.float32, device=dev)
    win, fb, bands, dct = tmel._mfcc_constants(nfft, n_mels, n_mfcc, sr, 0.0,
                                               sr / 2, lifter, "htk", "hann",
                                               None, dev)
    mel = tstk.stft_mel_stockham(x, nfft, hop, win, fb, bands)
    want = tstk.stft_mel_stockham_plain(x, nfft, hop, win, fb)
    assert mel.shape == want.shape == (channels, want.shape[1], n_mels)
    assert _rel(mel, want) < 5e-5
    before = tstk.stft_mel_stockham.launches
    got = tstk.stft_mel_stockham(x, nfft, hop, win, fb, bands, dct)
    torch.cuda.synchronize()
    assert tstk.stft_mel_stockham.launches == before + 1
    want = tstk.stft_mel_stockham_plain(x, nfft, hop, win, fb, dct)
    assert got.shape == want.shape == (channels, want.shape[1], n_mfcc)
    err = (got - want).abs().max().item()
    assert err < max(5e-4, 5e-6 * want.abs().max().item())


def _tones(channels, n, nfft, seed, dev):
    """Tones at bins 10, 25 and 45 of nfft = 128 (amplitudes 1, 0.7, 0.02,
    scaled with nfft) over N(0, 1e-4^2) noise: every bin of a frame inside
    the signal is >= 10x above or below 0.01 of the frame's peak power."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 1e-4 * rng.standard_normal((channels, n))
    for k, a in ((10, 1.0), (25, 0.7), (45, 0.02)):
        x += a * np.cos(2 * np.pi * k * (nfft // 128) * t / nfft
                        + rng.uniform(0, 2 * np.pi, (channels, 1)))
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _gate_pair(x, nfft, hop, threshold, dev):
    """(kernel, its rerun, plain, norm) of the fused gate on x padded by
    nfft - hop at both ends, as SpectralGate pads it."""
    pad = nfft - hop
    xp = torch.nn.functional.pad(x, (pad, pad))
    n_pad = xp.shape[-1]
    win = STFT(nfft, hop).win(dev)
    norm = tik.ola_norm(get_window_np("hann", nfft), hop,
                        stft_num_frames(n_pad, nfft, hop), n_pad, dev)
    before = tstk.stft_gate_stockham.launches
    got = tstk.stft_gate_stockham(xp, nfft, hop, win, norm, threshold)
    again = tstk.stft_gate_stockham(xp, nfft, hop, win, norm, threshold)
    torch.cuda.synchronize()
    assert tstk.stft_gate_stockham.launches == before + 2
    want = tstk.stft_gate_stockham_plain(xp, nfft, hop, win, norm, threshold)
    assert got.shape == want.shape == xp.shape
    return got, again, want, norm


@pytest.mark.parametrize("nfft,hop", FR_GEOMETRIES + [(128, 64)])
@pytest.mark.parametrize("channels,n", [(1, 700), (2, 9001)])
def test_stockham_gate_kernel_matches_plain(dev, gen, nfft, hop, channels, n):
    """Threshold 0 on dense input, a pure roundtrip: before the norm over
    the full length (after it, the 1/w^2 norm amplifies float32 rounding
    where the cover thins out) and after it on the samples SpectralGate
    keeps, which equal the input; the same bits on a second run. 700
    samples are fewer than one group of frames spans at every geometry."""
    pad = nfft - hop
    x = torch.as_tensor(gen.standard_normal((channels, n)),
                        dtype=torch.float32, device=dev)
    got, again, want, norm = _gate_pair(x, nfft, hop, 0.0, dev)
    assert torch.equal(got, again)
    assert _rel(got * norm, want * norm) < 5e-6
    assert _rel(got[:, pad:pad + n], want[:, pad:pad + n]) < 5e-6
    assert _rel(got[:, pad:pad + n], x) < 5e-6


@pytest.mark.parametrize("nfft,hop", FR_GEOMETRIES)
@pytest.mark.parametrize("channels", [1, 2])
def test_stockham_gate_kernel_on_the_tone_probe(dev, nfft, hop, channels):
    """Threshold 0.1 on tones whose bins all clear it by >= 10x in every
    frame inside the signal; held on the samples only such frames reach,
    more than 2 (nfft - hop) from either end of the padded signal."""
    edge = 2 * (nfft - hop)
    got, again, want, norm = _gate_pair(_tones(channels, 9001, nfft, 3, dev),
                                        nfft, hop, 0.1, dev)
    assert torch.equal(got, again)
    assert _rel(got[:, edge:-edge], want[:, edge:-edge]) < 5e-6


def test_stockham_entry_points_on_card_match_cpu(dev, gen):
    """STFT.power, MFCCFrontend and SpectralGate at 128/32 and process at
    512/8 through the full-nfft kernels, against the CPU, each launching
    its one kernel (the gate on the tone probe, away from its edges)."""
    x = torch.as_tensor(gen.standard_normal((2, 8192)), dtype=torch.float32)
    xd = x.to(dev)
    names = ("stft_spectrum_stockham", "stft_power_stockham",
             "stft_mel_stockham", "stft_gate_stockham")
    counts = [getattr(tstk, f).launches for f in names]
    plan = STFT(128, 32)
    assert _rel(plan.power(xd), plan.power(x)) < 5e-5
    front = dict(nfft=128, hop=32, n_mels=26, n_mfcc=13, sample_rate=8000.0)
    err = (MFCCFrontend(**front, device=dev)(xd).cpu()
           - MFCCFrontend(**front, device="cpu")(x)).abs().max()
    assert err.item() < 5e-4
    probe = _tones(2, 8192, 128, 4, "cpu")
    assert _rel(SpectralGate(128, 32, device=dev)(probe.to(dev))[:, 96:-96],
                SpectralGate(128, 32, device="cpu")(probe)[:, 96:-96]) < 5e-6
    for rfft in (False, True):
        assert _cplx_rel(STFT(512, 8).process(xd, rfft=rfft),
                         STFT(512, 8).process(x, rfft=rfft)) < 5e-5
    torch.cuda.synchronize()
    after = [getattr(tstk, f).launches for f in names]
    assert [a - b for a, b in zip(after, counts)] == [2, 1, 1, 1]


def test_stockham_wrappers_refuse_what_they_do_not_take(dev, gen):
    x = torch.as_tensor(gen.standard_normal((2, 9000)), dtype=torch.float32,
                        device=dev)
    for nfft, hop in ((2048, 8), (128, 24), (4096, 1024), (64, 16)):
        win = torch.ones(nfft, device=dev)
        with pytest.raises(ValueError):
            tstk.stft_spectrum_stockham(x, nfft, hop, win)
        with pytest.raises(ValueError):
            tstk.stft_power_stockham(x, nfft, hop, win)
    win = STFT(128, 128).win(dev)
    with pytest.raises(ValueError):   # the gate needs hop < nfft
        tstk.stft_gate_stockham(x, 128, 128, win, torch.ones(9000,
                                                              device=dev), 0.1)
    before = [f.launches for f in _counters()]
    # SpectralGate at 128/128 and STFT at 128/24: no kernel takes them, the
    # "torch" route runs on the card
    assert _gate_rel(SpectralGate(128, 128, device=dev)(x),
                     SpectralGate(128, 128, device="cpu")(x.cpu()),
                     128, 128) < 5e-6
    assert _cplx_rel(STFT(128, 24).process(x),
                     STFT(128, 24).process(x.cpu())) < 5e-5
    torch.cuda.synchronize()
    assert [f.launches for f in _counters()] == before
    with pytest.raises(TypeError):
        tstk.stft_power_stockham(x.double(), 128, 32, STFT(128, 32).win(dev))


# the direct FIR (fir_direct) and the per-phase resampler (poly_kernel):
# 2e-5 of max |y| for the FIR (the JAX package's FIR tolerance; the kernel
# sums k = 0..taps-1, cuDNN in its own order), 1e-5 for the resampler (at
# most 41 products a phase at these ratios)
FIR_TOL = 2e-5
POLY_TOL = 1e-5


def _lowpass(taps):
    return design_lowpass_np(taps, 0.3) if taps > 1 else np.array([0.5])


@pytest.mark.parametrize("taps", [1, 2, 7, 16, 129, 2048])
@pytest.mark.parametrize("channels,n", [(1, 1), (3, 100), (2, 5001),
                                        (5, 4097)])
def test_fir_direct_kernel_matches_plain(dev, gen, taps, channels, n):
    """Ragged n and channels off any tile, n < taps (the window's zero
    history), the same bits on a second run."""
    x = torch.as_tensor(gen.standard_normal((channels, n)),
                        dtype=torch.float32, device=dev)
    h = _lowpass(taps)
    before = tfk.fir_direct.launches
    got = tfk.fir_direct(h, x)
    again = tfk.fir_direct(h, x)
    torch.cuda.synchronize()
    assert tfk.fir_direct.launches == before + 2
    want = tfk.fir_direct_plain(h, x)
    assert got.shape == (channels, n) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert _rel(got, want) < FIR_TOL


def test_fir_direct_refuses_what_the_pallas_kernel_refuses(dev, gen):
    x = torch.as_tensor(gen.standard_normal((2, 3000)), dtype=torch.float32,
                        device=dev)
    before = tfk.fir_direct.launches
    for taps in (2049, 5000):
        with pytest.raises(ValueError):
            tfk.fir_direct(np.ones(taps) / taps, x)
    with pytest.raises(TypeError):
        tfk.fir_direct(_lowpass(16), x.double())
    with pytest.raises(ValueError):
        tfk.fir_direct(_lowpass(16), x[:, ::2])
    assert tfk.fir_direct.launches == before
    # a refused call leaves no error behind for the next one
    assert _rel(tfk.fir_direct(_lowpass(16), x),
                tfk.fir_direct_plain(_lowpass(16), x)) < FIR_TOL


@pytest.mark.parametrize("up,down", [(2, 1), (1, 2), (4, 3), (3, 4), (7, 5),
                                     (5, 7), (8, 7), (1, 25), (24, 1),
                                     (24, 23), (23, 24), (11, 12), (13, 6),
                                     (5, 4), (2, 3)])
@pytest.mark.parametrize("channels,n", [(1, 7), (3, 5001), (2, 100)])
def test_poly_kernel_matches_plain(dev, gen, up, down, channels, n):
    """Every phase layout (up and down each 1 or not, up > down and
    up < down, the largest down and up under up * taps_pp <= 512), one
    geometry of each instance K (ops/poly_plan.py: 24/23 and 23/24 K = 1,
    11/12 2, 8/7 3, 13/6 4, 7/5 5, 5/4 6, 4/3 7, 2/3 11, 2/1 21), signals
    shorter than a phase's taps, the same bits on a second run."""
    x = torch.as_tensor(gen.standard_normal((channels, n)),
                        dtype=torch.float32, device=dev)
    before = tfk.resample_poly_kernel.launches
    got = tfk.resample_poly_kernel(x, up, down)
    again = tfk.resample_poly_kernel(x, up, down)
    torch.cuda.synchronize()
    assert tfk.resample_poly_kernel.launches == before + 2
    want = tfk.resample_poly_plain(x, up, down)
    assert got.shape == want.shape == (channels, -(-n * up // down))
    assert torch.equal(got, again)
    assert _rel(got, want) < POLY_TOL


def test_poly_kernel_at_every_geometry(dev, gen):
    """All 377 reduced ratios resample_poly_kernel sends to the kernel
    (up * taps_pp <= 512), each one launch, against the plain version."""
    x = torch.as_tensor(gen.standard_normal((2, 4097)), dtype=torch.float32,
                        device=dev)
    geoms = tpp.kernel_geometries()
    assert len(geoms) == 377
    for up, down in geoms:
        before = tfk.resample_poly_kernel.launches
        got = tfk.resample_poly_kernel(x, up, down)
        torch.cuda.synchronize()
        assert tfk.resample_poly_kernel.launches == before + 1, (up, down)
        want = tfk.resample_poly_plain(x, up, down)
        assert got.shape == want.shape, (up, down)
        assert _rel(got, want) < POLY_TOL, (up, down)


def test_poly_kernel_rules(dev, gen):
    """up == down returns x; more than 512 weights (up * taps_pp) take
    resample_poly, the JAX launcher's static route; neither launches."""
    x = torch.as_tensor(gen.standard_normal((2, 3000)), dtype=torch.float32,
                        device=dev)
    before = tfk.resample_poly_kernel.launches
    assert tfk.resample_poly_kernel(x, 3, 3) is x
    got = tfk.resample_poly_kernel(x, 30, 7)
    assert tfk.resample_poly_kernel.launches == before
    assert _rel(got, trs.resample_poly(x, 30, 7)) < POLY_TOL
    with pytest.raises(TypeError):
        tfk.resample_poly_kernel(x.double(), 4, 3)


# the banded kernel at the geometries the filter and resample entry points
# give it: the FIR at up = down = 1 with 1024 taps (offset 0), and
# resample_poly's filters at offset half_len
@pytest.mark.parametrize("up,down,taps", [(1, 1, 1024), (2, 1, 0), (1, 2, 0),
                                          (8, 7, 0), (5, 7, 0), (4, 3, 0)])
@pytest.mark.parametrize("channels,n", [(1, 7), (3, 5001), (2, 30000)])
def test_upfirdn_kernel_at_the_filter_geometries(dev, gen, up, down, taps,
                                                 channels, n):
    if taps:
        g, off, n_out = design_lowpass_np(taps, 0.3), 0, n
    else:
        g = trs._resample_poly_filter(up, down)
        off, n_out = (len(g) - 1) // 2, -(-n * up // down)
    x = torch.as_tensor(gen.standard_normal((channels, n)),
                        dtype=torch.float32, device=dev)
    table = tuf.polyphase_table(g, up, dev)
    got = tuf.upfirdn_banded(x, table, up, down, off, n_out)
    again = tuf.upfirdn_banded(x, table, up, down, off, n_out)
    want = tuf.upfirdn_tall(x, table, up, down, off, n_out)
    assert got.shape == (channels, n_out)
    assert torch.equal(got, again)
    assert _rel(got, want) < 1e-5


def test_filter_entry_points_on_card_match_cpu(dev, gen):
    """fir_apply_best, resample_poly_best, resample_multistage,
    resample_poly_kernel and the staged chain on the card, each launching
    the kernels the JAX package's TPU routes run, against the CPU."""
    x = torch.as_tensor(gen.standard_normal((2, 24000)), dtype=torch.float32)
    xd = x.to(dev)
    counters = {"fir_direct": tfk.fir_direct,
                "poly_kernel": tfk.resample_poly_kernel,
                "upfirdn_banded": tuf.upfirdn_banded,
                "stft_mfcc": tsk.stft_mfcc, "fir_os": tfk.fir_os}
    staged = (NorthStarChain(fused_head=False, device="cpu"),
              NorthStarChain(fused_head=False, device=dev))
    paths = [(f"fir_{t}", lambda v, t=t: tfk.fir_apply_best(_lowpass(t), v),
              tol, want)
             for t, tol, want in ((16, FIR_TOL, {"fir_direct": 1}),
                                  (64, FIR_TOL, {}), (256, FIR_TOL, {}),
                                  (1024, FIR_TOL, {"fir_os": 1}))]
    paths += [(f"resample_{u}_{d}",
               lambda v, u=u, d=d: tfk.resample_poly_best(v, u, d), POLY_TOL,
               want)
              for u, d, want in ((2, 1, {"upfirdn_banded": 1}),
                                 (1, 2, {"upfirdn_banded": 1}),
                                 (4, 3, {"upfirdn_banded": 1}),
                                 (160, 147, {}))]
    paths += [("multistage", lambda v: trs.resample_multistage(v, 160, 147),
               POLY_TOL, {"upfirdn_banded": 3}),
              ("poly_kernel", lambda v: tfk.resample_poly_kernel(v, 4, 3),
               POLY_TOL, {"poly_kernel": 1}),
              ("staged chain", lambda v: staged[v.is_cuda](v), 5e-5,
               {"fir_os": 1, "upfirdn_banded": 1, "stft_mfcc": 1})]
    for name, fn, tol, want in paths:
        ref = fn(x)
        for f in counters.values():
            f.launches = 0
        got = fn(xd)
        torch.cuda.synchronize()
        assert {k: f.launches for k, f in counters.items()
                if f.launches} == want, name
        assert got.shape == ref.shape, name
        assert _rel(got, ref) < tol, name


def test_fir_apply_best_gradient_on_card(dev, gen):
    """The direct route's backward differentiates fir_apply on the card:
    d/dh and d/dx match the CPU's."""
    x = torch.as_tensor(gen.standard_normal((2, 5000)), dtype=torch.float32)
    cot = torch.as_tensor(gen.standard_normal((2, 5000)), dtype=torch.float32)
    h = torch.as_tensor(_lowpass(16), dtype=torch.float32)
    grads = []
    for d in ("cpu", dev):
        xt = x.to(d).requires_grad_(True)
        ht = h.to(d).requires_grad_(True)
        grads.append(torch.autograd.grad(tfk.fir_apply_best(ht, xt),
                                         (xt, ht), cot.to(d)))
    for got, want in zip(grads[1], grads[0]):
        assert _rel(got, want) < 1e-5


@pytest.fixture
def fir_cell_rows(dev):
    """The ``fir1024.batch64`` cell's call: 64 x 479,232 N(0, 1) rows on the
    card and its 1,024 taps at cutoff 0.45 designed on the card."""
    g = torch.Generator(device=dev).manual_seed(2**31 + 26)
    x = torch.randn((64, 479232), generator=g, device=dev)
    return design_lowpass(1024, 0.45, device=dev), x


def _reads_card_taps_back_once(h, x, wrapper):
    """fir_apply_best(h, x) launches wrapper once a call, and from its
    second call on copies nothing from the card (CUDA's sync-debug mode
    raises on a synchronising copy)."""
    tfk.fir_apply_best(h, x)
    torch.cuda.synchronize()
    before = wrapper.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        tfk.fir_apply_best(h, x)
        tfk.fir_apply_best(h, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2


def test_fir_apply_best_reads_card_taps_back_once(dev, fir_cell_rows):
    """With taps on the card, the overlap-save route's first call reads
    them back and puts their table on the card; later calls launch the
    kernel once each and copy nothing from the card."""
    _reads_card_taps_back_once(*fir_cell_rows, tfk.fir_os)


def test_fir_apply_best_banded_route_reads_card_taps_back_once(
        dev, fir_cell_rows):
    """The same of the banded route, at bf16x3."""
    with config.matmul_precision("high"):
        _reads_card_taps_back_once(*fir_cell_rows, tuf.upfirdn_banded)


def test_fir_cell_call_runs_the_os_route_only(dev, fir_cell_rows):
    """The cell's call is one overlap-save call: route_calls["os"] and
    fir_os.launches move by one, no other route or kernel moves."""
    h, x = fir_cell_rows
    before = dict(tfk.fir_apply_best.route_calls)
    launches = [f.launches for f in _counters()]
    tfk.fir_apply_best(h, x)
    torch.cuda.synchronize()
    after = tfk.fir_apply_best.route_calls
    assert {k: after[k] - before[k] for k in after} == {
        "direct": 0, "mxu": 0, "banded": 0, "os": 1}
    assert [f.launches - b for f, b in zip(_counters(), launches)] == [
        1 if f is tfk.fir_os else 0 for f in _counters()]


# the overlap-save kernel against its plain version (the same segments and
# table through cuFFT): 1e-6 of max |y| (float32 FFTs of 4,096 points in
# another order, measured 3.9e-7 at the cell's shape), and below n = taps,
# where the outputs are the filter's first taps alone, 1e-6 of the largest
# output the filter gives on the input (tests/test_torch_fir_os.py)
OS_TOL = 1e-6


def _os_err(got, want, h, x):
    err = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    if x.shape[-1] < len(h):
        scale = float(np.abs(h).sum()) * x.abs().max().item()
    return err / scale


def test_fir_os_matches_plain_at_the_cell_shape(dev, fir_cell_rows):
    h, x = fir_cell_rows
    table = tfk.os_table(h, dev)
    before = tfk.fir_os.launches
    got = tfk.fir_os(x, table, 1024)
    again = tfk.fir_os(x, table, 1024)
    torch.cuda.synchronize()
    assert tfk.fir_os.launches == before + 2
    assert torch.equal(got, again)
    for r0 in range(0, x.shape[0], 16):
        rows = x[r0:r0 + 16]
        want = tfk.fir_os_plain(rows, table, 1024)
        assert _os_err(got[r0:r0 + 16], want, h, rows) < OS_TOL


@pytest.mark.parametrize("taps", [1, 17, 512, 513, 1024, 2047, 2048])
@pytest.mark.parametrize("channels", [1, 3])
def test_fir_os_matches_plain_at_its_edges(dev, gen, taps, channels):
    """n = 1, 7, 100, one block either side of one and two blocks, past
    them; each row's segments start off the card's 8-byte lines where n is
    odd."""
    h = _lowpass(taps)
    table = tfk.os_table(h, dev)
    block = tfk.os_geometry(taps)[1]
    for n in (1, 7, 100, block - 1, block, block + 1, 2 * block + 3, 40001):
        x = torch.as_tensor(gen.standard_normal((channels, n)),
                            dtype=torch.float32, device=dev)
        got = tfk.fir_os(x, table, taps)
        assert got.shape == x.shape
        assert _os_err(got, tfk.fir_os_plain(x, table, taps), h, x) < OS_TOL


def test_fir_os_on_an_unaligned_row(dev, gen):
    h = _lowpass(1024)
    table = tfk.os_table(h, dev)
    flat = torch.as_tensor(gen.standard_normal(3 * 9001 + 1),
                           dtype=torch.float32, device=dev)
    x = flat[1:].reshape(3, 9001)
    assert x.data_ptr() % 8 and x.is_contiguous()
    got = tfk.fir_os(x, table, 1024)
    assert _os_err(got, tfk.fir_os_plain(x, table, 1024), h, x) < OS_TOL


def test_fir_os_refuses_what_it_does_not_take(dev):
    x = torch.zeros((2, 5000), device=dev)
    table = tfk.os_table(_lowpass(64), dev)
    with pytest.raises(TypeError):
        tfk.fir_os(x.double(), table, 64)
    with pytest.raises(ValueError):
        tfk.fir_os(x[:, ::2], table, 64)
    with pytest.raises(ValueError):
        tfk.fir_os(x, table.cpu(), 64)
    with pytest.raises(ValueError):
        tfk.fir_os(x, table[:-1], 64)
    with pytest.raises(ValueError):
        tfk.fir_os(x, table, tfk.KERNEL_MAX_TAPS + 1)
    assert tfk.fir_os(x[:, :0], table, 64).shape == (2, 0)


def test_fir_apply_best_card_taps_are_the_host_taps_bit_for_bit(
        dev, fir_cell_rows):
    """At the cell's shape: card taps give the host taps' bits, and both
    lie within the cell's limit of the float64 reference."""
    from h100bench.reference import fir_lowpass_1024 as fref
    from h100bench.reference.common import MaxError
    h, x = fir_cell_rows
    got = tfk.fir_apply_best(h, x)
    host = tfk.fir_apply_best(h.cpu().double().numpy(), x)
    assert _sha256(got) == _sha256(host)
    fields = {"fir_taps": 1024, "fir_cutoff": 0.45, "window": "hamming"}
    acc = MaxError()
    for r0 in range(0, x.shape[0], 8):
        acc.add(got[r0:r0 + 8], fref.call(fields, x[r0:r0 + 8]))
    assert acc.numbers()["err_of_scale"] < fref.LIMITS["call"][
        "err_of_scale"]


# the three kernels of the last slice: the windowed-DFT power (1e-5 of max
# power, tests/test_pallas.py's pin), the full-nfft inverse and the packed
# fused gate (5e-6 of scale before the norm is divided out, the inverse
# kernel's pin above; the gate after it on the samples SpectralGate keeps)
@pytest.mark.parametrize("nfft,hop", [(256, 128), (512, 256), (1024, 256),
                                      (1024, 1024), (2048, 512),
                                      (4096, 128)])
@pytest.mark.parametrize("channels,n", [(1, 700), (3, 9001)])
def test_dft_power_kernel_matches_plain(dev, gen, nfft, hop, channels, n):
    """n < nfft (one frame) at the larger nffts; the last bin tile ragged
    (nfft/2 + 1 bins against 64-bin tiles); frames past the signal."""
    x = torch.as_tensor(gen.standard_normal((channels, n)),
                        dtype=torch.float32, device=dev)
    for nf in (None, stft_num_frames(n, nfft, hop) + 3):
        before = tsk.stft_power_dft.launches
        got = tsk.stft_power_dft(x, nfft, hop, "hann", None, nf)
        torch.cuda.synchronize()
        assert tsk.stft_power_dft.launches == before + 1
        want = tsk.stft_power_dft_plain(x, nfft, hop, "hann", None, nf)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _rel(got, want) < 1e-5
    win = STFT(nfft, hop).win(dev)
    assert _rel(tsk.stft_power_dft(x, nfft, hop),
                tsk.stft_power_plain(x, nfft, hop, win)) < 1e-5


def test_dft_power_refuses_what_it_does_not_take(dev, gen):
    x = torch.as_tensor(gen.standard_normal((2, 4096)), dtype=torch.float32,
                        device=dev)
    for nfft, hop in ((1000, 250), (2048, 640), (1024, 64)):
        with pytest.raises(ValueError):
            tsk.stft_power_dft(x, nfft, hop)
    with pytest.raises(TypeError):
        tsk.stft_power_dft(x.double(), 1024, 256)
    with pytest.raises(ValueError):
        tsk.stft_power_dft(x[None], 1024, 256)


@pytest.mark.parametrize("nfft,hop", [(128, 32), (128, 8), (128, 128),
                                      (256, 64), (512, 512), (1024, 256),
                                      (1024, 8), (2048, 512)])
@pytest.mark.parametrize("rfft", [False, True])
def test_istft_stockham_kernel_matches_plain(dev, gen, nfft, hop, rfft):
    """A non-Hermitian spectrum with all nfft bins, the one-sided half of
    one (DC and Nyquist imaginary parts included); output_len at, short of
    and beyond the frames' cover; the same bits on a second run."""
    nf = 37
    bins = nfft // 2 + 1 if rfft else nfft
    spec = torch.complex(
        torch.as_tensor(gen.standard_normal((2, nf, bins)),
                        dtype=torch.float32),
        torch.as_tensor(gen.standard_normal((2, nf, bins)),
                        dtype=torch.float32)).to(dev)
    win = STFT(nfft, hop).win(dev)
    cover = (nf - 1) * hop + nfft
    for out_len in (cover, max(cover - hop - 5, nfft // 2), cover + 2 * nfft):
        norm = tik.ola_norm(get_window_np("hann", nfft), hop, nf, out_len,
                            dev)
        before = tstk.istft_stockham.launches
        got = tstk.istft_stockham(spec, nfft, hop, out_len, win, norm, rfft)
        again = tstk.istft_stockham(spec, nfft, hop, out_len, win, norm,
                                    rfft)
        torch.cuda.synchronize()
        assert tstk.istft_stockham.launches == before + 2
        want = tstk.istft_stockham_plain(spec, nfft, hop, out_len, win, norm,
                                         rfft)
        assert got.shape == (2, out_len)
        assert torch.equal(got, again)
        assert _rel(got * norm, want * norm) < 5e-6, out_len
        if out_len > cover:
            assert (got[:, cover:] == 0).all()


@pytest.mark.parametrize("nfft", [128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("rfft", [False, True])
def test_istft_stockham_at_every_transform_size(dev, gen, nfft, rfft):
    """Every transform size in both forms, at the smallest hop the lattice
    takes, nfft/4 and hop = nfft; an even and an odd frame count and one
    frame; output_len at, short of and beyond the cover; the same bits on
    a second run."""
    bins = nfft // 2 + 1 if rfft else nfft
    win = None
    for hop in (max(8, nfft // 128), nfft // 4, nfft):
        assert tstk.stockham_supported(nfft, hop)
        win = STFT(nfft, hop).win(dev)
        for nf in (1, 6, 11):
            spec = torch.complex(*(torch.as_tensor(
                gen.standard_normal((2, nf, bins)), dtype=torch.float32)
                for _ in range(2))).to(dev)
            cover = (nf - 1) * hop + nfft
            for out_len in (cover, max(cover - hop - 5, nfft // 2),
                            cover + nfft + 3):
                norm = tik.ola_norm(get_window_np("hann", nfft), hop, nf,
                                    out_len, dev)
                got = tstk.istft_stockham(spec, nfft, hop, out_len, win,
                                          norm, rfft)
                again = tstk.istft_stockham(spec, nfft, hop, out_len, win,
                                            norm, rfft)
                want = tstk.istft_stockham_plain(spec, nfft, hop, out_len,
                                                 win, norm, rfft)
                assert torch.equal(got, again)
                assert _rel(got * norm, want * norm) < 5e-6, (hop, nf,
                                                               out_len)
                if out_len > cover:
                    assert (got[:, cover:] == 0).all()


def test_istft_stockham_refuses_what_it_does_not_take(dev):
    spec = torch.zeros(2, 5, 65, dtype=torch.complex64, device=dev)
    win, norm = STFT(128, 32).win(dev), torch.ones(300, device=dev)
    for nfft, hop in ((128, 24), (4096, 1024), (2048, 8)):
        sp = torch.zeros(2, 5, nfft // 2 + 1, dtype=torch.complex64,
                         device=dev)
        with pytest.raises(ValueError):   # the CPU takes these; no kernel
            tstk.istft_stockham(sp, nfft, hop, 300, torch.ones(nfft,
                                                                device=dev),
                                norm, rfft=True)
    with pytest.raises(TypeError):
        tstk.istft_stockham(spec.to(torch.complex128), 128, 32, 300, win,
                            norm, rfft=True)
    with pytest.raises(ValueError):       # 65 bins are not rfft=False's 128
        tstk.istft_stockham(spec, 128, 32, 300, win, norm, rfft=False)


def _packed_gate_pair(x, nfft, hop, threshold, dev):
    """(kernel, its rerun, plain, norm) of the packed fused gate on x padded
    by nfft - hop at both ends, as SpectralGate pads it."""
    pad = nfft - hop
    xp = torch.nn.functional.pad(x, (pad, pad))
    win = STFT(nfft, hop).win(dev)
    norm = tik.periodic_norm(get_window_np("hann", nfft), hop, xp.shape[-1],
                             dev)
    before = tik.stft_gate_packed.launches
    got = tik.stft_gate_packed(xp, nfft, hop, threshold, win, norm)
    again = tik.stft_gate_packed(xp, nfft, hop, threshold, win, norm)
    torch.cuda.synchronize()
    assert tik.stft_gate_packed.launches == before + 2
    want = tik.stft_gate_packed_plain(xp, nfft, hop, threshold, win, norm)
    assert got.shape == want.shape == xp.shape
    return got, again, want, norm


PACKED_GATE_GEOMETRIES = [(256, 64), (256, 128), (512, 128), (1024, 256),
                          (1024, 16), (2048, 512), (4096, 1024), (4096, 32)]


@pytest.mark.parametrize("nfft,hop", PACKED_GATE_GEOMETRIES)
@pytest.mark.parametrize("channels,n", [(1, 700), (2, 9001)])
def test_stft_gate_packed_kernel_matches_plain(dev, gen, nfft, hop, channels,
                                               n):
    """Threshold 0 on dense input, a pure roundtrip: before the norm over
    the full length, and on the samples SpectralGate keeps, which equal the
    input; q = 2 to 128; the same bits on a second run."""
    pad = nfft - hop
    x = torch.as_tensor(gen.standard_normal((channels, n)),
                        dtype=torch.float32, device=dev)
    got, again, want, norm = _packed_gate_pair(x, nfft, hop, 0.0, dev)
    assert torch.equal(got, again)
    assert _rel(got * norm, want * norm) < 5e-6
    assert _rel(got[:, pad:pad + n], want[:, pad:pad + n]) < 5e-6
    assert _rel(got[:, pad:pad + n], x) < 5e-6


@pytest.mark.parametrize("nfft,hop", [(256, 64), (1024, 256), (2048, 512),
                                      (1024, 16)])
def test_stft_gate_packed_kernel_on_the_tone_probe(dev, nfft, hop):
    """Threshold 0.1 on tones whose bins all clear it by >= 10x in every
    frame inside the signal, on the samples only such frames reach."""
    edge = 2 * (nfft - hop)
    got, again, want, _ = _packed_gate_pair(_tones(2, 9001 + nfft, nfft, 3,
                                                   dev), nfft, hop, 0.1, dev)
    assert torch.equal(got, again)
    assert _rel(got[:, edge:-edge], want[:, edge:-edge]) < 5e-6


def test_stft_gate_packed_refuses_what_it_does_not_take(dev, gen):
    x = torch.as_tensor(gen.standard_normal((2, 9000)), dtype=torch.float32,
                        device=dev)
    norm = torch.ones(9000, device=dev)
    for nfft, hop in ((128, 32), (1024, 1024), (1024, 8), (8192, 2048)):
        with pytest.raises(ValueError):   # the CPU takes these; no kernel
            tik.stft_gate_packed(x, nfft, hop, 0.1,
                                 torch.ones(nfft, device=dev), norm)
    win = STFT(1024, 256).win(dev)
    with pytest.raises(TypeError):
        tik.stft_gate_packed(x.double(), 1024, 256, 0.1, win, norm)
    with pytest.raises(ValueError):
        tik.stft_gate_packed(x, 1024, 256, 0.1, win, norm, "bf16x3")


# the packed inverse and fused gate on the register-resident FFT: every
# transform size M = nfft/2 (128 to 2048), the inverse to q = 256 and the
# gate to its q = 128, short and ragged signals, several shared-memory sizes
# of one instance in one process, and the launchers' plan checks
PACKED_NFFTS = (256, 512, 1024, 2048, 4096)


@pytest.mark.parametrize("nfft", PACKED_NFFTS)
def test_istft_kernel_at_every_transform_size(dev, gen, nfft):
    """A random one-sided spectrum (DC and Nyquist imaginary parts
    included) at hop = nfft, nfft/4 and nfft/256 (q = 1, 4, 256); 1, 6 and
    11 frames; output_len at, short of and beyond the cover; no gate and
    gates at 0.1 and 1, the plain version fed the same spectrum; the same
    bits on a second run."""
    bins = nfft // 2 + 1
    for hop in (nfft, nfft // 4, nfft // 256):
        win = STFT(nfft, hop).win(dev)
        for nf in (1, 6, 11):
            spec = torch.complex(*(torch.as_tensor(
                gen.standard_normal((2, nf, bins)), dtype=torch.float32)
                for _ in range(2))).to(dev)
            cover = (nf - 1) * hop + nfft
            for out_len in (cover, max(cover - hop - 5, nfft // 2),
                            cover + nfft + 3):
                norm = tik.ola_norm(get_window_np("hann", nfft), hop, nf,
                                    out_len, dev)
                for gate in (None, 0.1, 1.0):
                    got = tik.istft(spec, nfft, hop, out_len, win, norm, gate)
                    again = tik.istft(spec, nfft, hop, out_len, win, norm,
                                      gate)
                    want = tik.istft_plain(spec, nfft, hop, out_len, win,
                                           norm, gate)
                    assert torch.equal(got, again)
                    assert _rel(got * norm, want * norm) < 5e-6, (
                        hop, nf, out_len, gate)
                    if out_len > cover:
                        assert (got[:, cover:] == 0).all()


@pytest.mark.parametrize("nfft", PACKED_NFFTS)
@pytest.mark.parametrize("n", [300, 9001])
def test_stft_gate_packed_kernel_at_every_transform_size(dev, gen, nfft, n):
    """hop = nfft/2, nfft/4 and the lattice's smallest (16, or nfft/128:
    q = 128 at 4096/32); a signal shorter than a frame and a ragged one;
    threshold 0 on dense input (the input back on the retained samples)
    and 0.1 on the tone probe; the same bits on a second run."""
    for hop in (nfft // 2, nfft // 4, max(16, nfft // 128)):
        assert tsk.packed_gate_supported(nfft, hop)
        pad = nfft - hop
        x = torch.as_tensor(gen.standard_normal((2, n)), dtype=torch.float32,
                            device=dev)
        got, again, want, norm = _packed_gate_pair(x, nfft, hop, 0.0, dev)
        assert torch.equal(got, again)
        assert _rel(got * norm, want * norm) < 5e-6, hop
        assert _rel(got[:, pad:pad + n], x) < 5e-6, hop
        edge = pad + nfft        # every frame reaching in lies in the tones
        got, again, want, _ = _packed_gate_pair(
            _tones(2, n + 4 * nfft, nfft, 3, dev), nfft, hop, 0.1, dev)
        assert torch.equal(got, again)
        assert _rel(got[:, edge:-edge], want[:, edge:-edge]) < 5e-6, hop


def test_packed_kernels_at_several_layout_sizes(dev, gen):
    """One instance (M = 2048) at three strip sizes in turns: fr_launch
    keeps a block count per shared-memory size and never lowers the
    kernel's limit, so each call still matches its plain version."""
    from vv_dsp_tpu_torch.ops import fft_plan
    nfft = 4096
    hops = (4096, 1024, 32)
    assert len({fft_plan.packed_istft_smem(nfft, h) for h in hops}) == 3
    x = torch.as_tensor(gen.standard_normal((2, 20000)), dtype=torch.float32,
                        device=dev)
    for hop in hops + hops[::-1]:
        win = STFT(nfft, hop).win(dev)
        spec = tsk.stft_spectrum(x, nfft, hop, win, onesided=True)
        nf = spec.shape[1]
        out_len = (nf - 1) * hop + nfft
        norm = tik.ola_norm(get_window_np("hann", nfft), hop, nf, out_len,
                            dev)
        for gate in (None, 0.1):
            got = tik.istft(spec, nfft, hop, out_len, win, norm, gate)
            want = tik.istft_plain(spec, nfft, hop, out_len, win, norm, gate)
            assert _rel(got * norm, want * norm) < 5e-6, (hop, gate)
        if hop < nfft:
            got, again, want, norm = _packed_gate_pair(x, nfft, hop, 0.0, dev)
            assert torch.equal(got, again)
            assert _rel(got * norm, want * norm) < 5e-6, hop


def test_packed_launchers_refuse_a_plan_not_their_own(dev):
    """The launchers check the host plan's shared-memory size against their
    own reckoning of the layout, and launch nothing on a mismatch."""
    from vv_dsp_tpu_torch import _build
    from vv_dsp_tpu_torch.ops import fft_plan
    lib = _build.library()
    nfft, hop, nf, n = 1024, 256, 5, 2048
    spec = torch.zeros(1, nf, nfft // 2 + 1, dtype=torch.complex64,
                       device=dev)
    x = torch.zeros(1, n, device=dev)
    out = torch.full((1, n), 7.0, device=dev)
    win = STFT(nfft, hop).win(dev)
    norm = torch.ones(n, device=dev)
    tw = fft_plan.pass_twiddles(nfft // 2, dev)
    wk = tsk._fft_tables(nfft, dev)[1]
    ptrs = [_build.ptr(t) for t in (win, tw, wk, norm, out)]
    plan = fft_plan.packed_istft_smem(nfft, hop)
    gate_plan = fft_plan.gate_packed_smem(nfft, hop)
    # each block its own layout: the inverse's with its spectrum stage
    assert (plan, gate_plan) == (73816, 61416)
    for smem in (plan - 8, plan + 8, gate_plan, plan + 4,
                 fft_plan.packed_istft_smem(nfft, 1) + 8 * 1024):
        for gate in (0, 1):
            assert lib.vv_istft(_build.ptr(spec), *ptrs, 1, nf, nfft, hop, n,
                                gate, 0.01, smem, dev.index,
                                _build.stream_handle(spec), None) != 0
    for smem in (gate_plan - 8, gate_plan + 8, plan, gate_plan + 4,
                 fft_plan.gate_packed_smem(nfft, 16) + 8 * 1024):
        assert lib.vv_stft_gate_packed(
            _build.ptr(x), *ptrs, 1, n, nf, nfft, hop, 0.01, smem,
            dev.index, _build.stream_handle(x)) != 0
    torch.cuda.synchronize()
    assert (out == 7.0).all()
    assert lib.vv_istft(_build.ptr(spec), *ptrs, 1, nf, nfft, hop, n, 1,
                        0.01, plan, dev.index,
                        _build.stream_handle(spec), None) == 0
    torch.cuda.synchronize()
    assert (out == 0.0).all()


def _ring_case(dev, gen, c, nf, nfft, hop, gate, offset=0):
    """The packed inverse on a random (c, nf, nfft/2 + 1) spectrum whose
    first bin sits `offset` float2 past a 16-byte boundary, against its
    plain version, twice; the kernel's output. The DC and Nyquist bins
    keep random imaginary parts, which both versions drop (cuFFT's c2r
    transform reads them at such batches; the plain version zeroes them
    first)."""
    bins = nfft // 2 + 1
    flat = torch.complex(*(torch.as_tensor(
        gen.standard_normal(c * nf * bins + offset), dtype=torch.float32)
        for _ in range(2))).to(dev)
    spec = flat[offset:].view(c, nf, bins)
    assert (spec.data_ptr() % 16 == 8) == bool(offset % 2)
    win = STFT(nfft, hop).win(dev)
    out_len = (nf - 1) * hop + nfft
    norm = tik.ola_norm(get_window_np("hann", nfft), hop, nf, out_len, dev)
    got = tik.istft(spec, nfft, hop, out_len, win, norm, gate)
    assert torch.equal(got, tik.istft(spec, nfft, hop, out_len, win, norm,
                                      gate))
    want = tik.istft_plain(spec, nfft, hop, out_len, win, norm, gate)
    assert _rel(got * norm, want * norm) < 5e-6, (c, nf, nfft, hop, gate)
    return got


@pytest.mark.parametrize("gate", [None, 0.1])
@pytest.mark.parametrize("c,nf,nfft,hop,offset", [
    (2, 40, 1024, 256, 0),    # rows 513 bins long: every other row starts
    (2, 40, 1024, 256, 1),    # 8 bytes past 16, and the tensor itself
    (3, 1, 1024, 256, 1),     # nf < 2048/M: one row a group, partly empty
    (3, 3, 1024, 256, 0),
    (2, 5, 512, 128, 1),      # 8 frames a group at M = 256, nf < 8
    (96, 75, 1024, 256, 1),   # rows of 19,968 samples, more items than
    (200, 32, 4096, 512, 0),  # blocks: a block walks on to another channel
])
def test_istft_ring_walk(dev, gen, c, nf, nfft, hop, offset, gate):
    """The spectrum stage's copies (csrc/istft.cu): strips whose first
    frame is odd (an 8-byte-aligned copy), a tensor that starts 8 bytes
    past a 16-byte boundary, fewer frames than a group, and enough
    channels that blocks walk items across channel boundaries, the next
    item's first copy in flight (the grid holds at most 3 blocks an SM);
    each gated and not, equal to the plain version and to itself."""
    from vv_dsp_tpu_torch.ops import fft_plan
    if c >= 96:
        out_len = (nf - 1) * hop + nfft
        per_row = -(-(-(-out_len // hop)) // fft_plan.owned_segments(nfft,
                                                                     hop))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert c * per_row > 3 * sms
    _ring_case(dev, gen, c, nf, nfft, hop, gate, offset)


def test_istft_ring_tally_counts_only_under_a_profiler(dev, gen):
    """ring_tally counts exactly the walk's groups (fft_plan.istft_groups)
    and at most as many ready ones while a torch.profiler session runs,
    and nothing without one; the output is the same bits either way."""
    from vv_dsp_tpu_torch.ops import fft_plan
    c, nf, nfft, hop = 5, 75, 1024, 256
    tik.ring_tally(dev, reset=True)
    quiet = _ring_case(dev, np.random.default_rng(3), c, nf, nfft, hop, 0.1)
    assert tik.ring_tally(dev) == {"launches": 0, "groups": 0, "ready": 0}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _ring_case(dev, np.random.default_rng(3), c, nf, nfft, hop,
                            0.1)
    read = tik.ring_tally(dev, reset=True)
    groups = fft_plan.istft_groups(c, nf, nfft, hop, (nf - 1) * hop + nfft)
    assert read["launches"] == 2                      # the case runs twice
    assert read["groups"] == 2 * groups
    assert 0 <= read["ready"] <= read["groups"]
    assert torch.equal(quiet, traced)
    _ring_case(dev, gen, c, nf, nfft, hop, None)
    assert tik.ring_tally(dev) == {"launches": 0, "groups": 0, "ready": 0}


def test_stockham_launchers_refuse_a_plan_not_their_own(dev):
    """The full-nfft gate and mel launchers check the host plan's
    shared-memory size as the packed ones do, and launch nothing on a
    mismatch."""
    from vv_dsp_tpu_torch import _build
    from vv_dsp_tpu_torch.ops import fft_plan
    lib = _build.library()
    nfft, hop, n = 128, 32, 4096
    nf = stft_num_frames(n, nfft, hop)
    x = torch.zeros(1, n, device=dev)
    out = torch.full((1, n), 7.0, device=dev)
    win, fb, bands, dct = tmel._mfcc_constants(nfft, 26, 13, 8000.0, 0.0,
                                               4000.0, 0.0, "htk", "hann",
                                               None, dev)
    weights, index = tsk._mel_tables(fb, bands)
    feats = torch.full((1, nf, 13), 7.0, device=dev)
    tw = _build.ptr(fft_plan.pass_twiddles(nfft, dev))
    gate = fft_plan.stockham_gate_smem(nfft, hop)
    mel = fft_plan.stockham_mel_plan(nfft, 26, 13, weights.numel(), True)
    stream = _build.stream_handle(x)
    for d in (-8, 4):
        assert lib.vv_stockham_gate(
            _build.ptr(x), _build.ptr(win), tw, _build.ptr(out),
            _build.ptr(out), 1, n, nf, nfft, hop, 0.01, gate + d, dev.index,
            stream) != 0
        assert lib.vv_stockham_mel(
            _build.ptr(x), _build.ptr(win), tw, _build.ptr(weights),
            _build.ptr(index), _build.ptr(dct), _build.ptr(feats), 1, n, nf,
            nfft, hop, 26, 13, weights.numel(), 1e-10, 1, int(mel.staged),
            mel.smem + d, dev.index, stream) != 0
    torch.cuda.synchronize()
    assert (out == 7.0).all() and (feats == 7.0).all()


# Run in a fresh process, so that every stft_power instance it launches is
# launched there for the first time: two host threads launch each instance
# at once (ctypes calls release the GIL, so both reach fr_launch's cache
# together), then a second copy of the kernel library, loaded beside the
# first, launches the 4096-point instance, whose 65,512 bytes of shared
# memory need the kernel attribute its own fr_launch must set.
_LAUNCH_CACHE_SCRIPT = """
import os, shutil, sys, tempfile, threading
import numpy as np, torch
from vv_dsp_tpu_torch import _build
from vv_dsp_tpu_torch.ops import fft_plan
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops.stft import STFT

dev = torch.device("cuda", 0)
x = torch.as_tensor(np.random.default_rng(5).standard_normal((2, 9001)),
                    dtype=torch.float32, device=dev)
geos = [(256, 64), (512, 128), (1024, 256), (2048, 512), (4096, 1024)]
wins = {g: STFT(*g).win(dev) for g in geos}
_build.library()
meet = threading.Barrier(2)
got, errors = {}, []

def run(t):
    try:
        for g in geos:
            meet.wait()
            got[t, g] = [tsk.stft_power(x, *g, wins[g]) for _ in range(3)]
    except Exception as e:
        errors.append(repr(e))
        meet.abort()

threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
for th in threads:
    th.start()
for th in threads:
    th.join()
torch.cuda.synchronize()
assert not errors, errors
for g in geos:
    want = tsk.stft_power_plain(x, *g, wins[g])
    for t in range(2):
        for out in got[t, g]:
            err = ((out - want).abs().max() / want.abs().max()).item()
            assert err < 5e-5, (t, g, err)
with tempfile.TemporaryDirectory() as tmp:
    copy = os.path.join(tmp, "copy.so")
    shutil.copy(_build.build(), copy)
    lib2 = _build.load(copy)
    nfft, hop = 4096, 1024
    want = tsk.stft_power_plain(x, nfft, hop, wins[nfft, hop])
    nf = want.shape[1]
    out = torch.full_like(want, 7.0)
    tw = fft_plan.pass_twiddles(nfft // 2, dev)
    wk = tsk._fft_tables(nfft, dev)[1]
    err = lib2.vv_stft_power(
        _build.ptr(x), _build.ptr(wins[nfft, hop]), _build.ptr(tw),
        _build.ptr(wk), _build.ptr(out), 2, x.shape[1], nf, nfft, hop,
        dev.index, _build.stream_handle(x))
    torch.cuda.synchronize()
    assert err == 0, err
    assert ((out - want).abs().max() / want.abs().max()).item() < 5e-5
print("launch cache ok")
"""


def test_fr_launch_cache_across_threads_and_libraries(dev):
    """fr_launch's attribute and block-count cache under a lock and with
    internal linkage: two host threads launching fresh stft_power instances
    at once both get the plain version's powers, and a second loaded copy
    of the library keeps a cache of its own (its 4096-point launch sets its
    own kernel's shared-memory attribute)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _LAUNCH_CACHE_SCRIPT],
                       cwd=root, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "launch cache ok" in r.stdout


def test_last_slice_entry_points_on_card_match_cpu(dev, gen):
    """STFT(128, 32).process and reconstruct through the full-nfft kernels,
    the spectrogram and the parts family through the spectrum kernel and
    matmuls, against the CPU, with the launches each must make."""
    x = torch.as_tensor(gen.standard_normal((2, 8192)), dtype=torch.float32)
    xd = x.to(dev)
    counted = (tstk.stft_spectrum_stockham, tstk.istft_stockham,
               tsk.stft_spectrum, tsk.stft_power_dft, tik.stft_gate_packed)
    counts = [f.launches for f in counted]
    small = STFT(128, 32)
    for rfft in (False, True):
        spec = small.process(xd, rfft=rfft)
        assert _cplx_rel(spec, small.process(x, rfft=rfft)) < 5e-5
        back = small.reconstruct(spec, 8192, rfft=rfft)
        assert _rel(back[:, 128:-128], x[:, 128:-128]) < 5e-6
    plan = STFT(1024, 256)
    assert _rel(plan.spectrogram(xd), plan.spectrogram(x)) < 5e-5
    re, im = plan.power_parts(xd)
    cre, cim = plan.power_parts(x)
    assert _rel(re, cre) < 5e-5 and _rel(im, cim) < 5e-5
    assert _rel(plan.reconstruct_parts(re, im, 8192)[:, 1024:-1024],
                x[:, 1024:-1024]) < 5e-6
    torch.cuda.synchronize()
    after = [f.launches for f in counted]
    assert [a - b for a, b in zip(after, counts)] == [2, 2, 1, 0, 0]


# the two tensor-core kernels (csrc/mma_tiers.cuh): the banded upfirdn at
# every tier and every geometry the port launches, and the windowed-DFT
# power at q = nfft/hop = 1 to 5 (one to three sample tiles in flight) and
# chunk counts nfft/32 that do and do not divide its five B buffers
def _launch_geometry(name):
    """(table (up, taps_pp), up, down, offset) of a launch of the port."""
    if name == "chain":
        h = NorthStarChain(device="cpu").fir_coeffs.astype(np.float64)
        g, off = trs._fused_fir_resample_filter(tuple(h), 4, 3)
        return tuf.polyphase_table_np(g, 4), 4, 3, off
    if name == "fir1024":
        return tuf.polyphase_table_np(_lowpass(1024), 1), 1, 1, 0
    if name == "offset":
        g = trs._resample_poly_filter(4, 3)
        return tuf.polyphase_table_np(g, 4), 4, 3, 3 * len(g)
    if name in ("head_8_7", "head_5_7", "head_2048"):
        up, down, taps = {"head_8_7": (8, 7, 1024), "head_5_7": (5, 7, 1024),
                          "head_2048": (4, 3, 2048)}[name]
        chain = NorthStarChain(up=up, down=down, fir_taps=taps, device="cpu")
        h = chain.fir_coeffs.astype(np.float64)
        g, off = trs._fused_fir_resample_filter(tuple(h), up, down)
        return tuf.polyphase_table_np(g, up), up, down, off
    if name == "fir16384":       # B streamed in depth chunks
        return tuf.polyphase_table_np(_lowpass(16384), 1), 1, 1, 0
    if name == "decimate1000":   # A's rows copied: no window fits
        g = design_lowpass_np(21, 0.0009)
        return tuf.polyphase_table_np(g, 1), 1, 1000, 10
    up, down = name
    g = trs._resample_poly_filter(up, down)
    return tuf.polyphase_table_np(g, up), up, down, (len(g) - 1) // 2


@pytest.mark.parametrize("geom", ["chain", "fir1024", (2, 1), (1, 2), (4, 3),
                                  (8, 7), (5, 7), (31, 1), "offset",
                                  "head_8_7", "head_5_7", "head_2048",
                                  "fir16384", "decimate1000"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_tensor_core_upfirdn_at_every_launch_geometry(dev, gen, geom,
                                                      algorithm):
    """A ragged n_out (past the last whole frame), n_out short of the
    signal's, and a signal shorter than one frame of the plan."""
    table, up, down, off = _launch_geometry(geom)
    taps = torch.as_tensor(table, device=dev)
    # the plain version's own frames would hold a matrix of taps_pp squared
    group = 8 if table.shape[1] > 4096 else None
    for n, n_out in ((20011, -(-20011 * up // down)), (20011, 777), (5, 9)):
        x = torch.as_tensor(gen.standard_normal((3, n)), dtype=torch.float32,
                            device=dev)
        before = tuf.upfirdn_banded.launches
        got = tuf.upfirdn_banded(x, taps, up, down, off, n_out, algorithm)
        torch.cuda.synchronize()
        assert tuf.upfirdn_banded.launches == before + 1
        want = tuf.upfirdn_tall(x, taps, up, down, off, n_out, algorithm,
                                group)
        assert got.shape == (3, n_out)
        if want.abs().max() == 0:     # every output reads past the signal
            assert not got.any()
        else:
            assert _rel(got, want) < 1e-5, (n, n_out)


@pytest.mark.parametrize("up,down,fir_taps", [(8, 7, 1024), (5, 7, 1024),
                                              (4, 3, 2048)])
@pytest.mark.parametrize("head_algorithm", ALGORITHMS)
def test_fused_heads_on_card_match_cpu(dev, gen, up, down, fir_taps,
                                       head_algorithm):
    """NorthStarChain at the other ratios and filter lengths it takes,
    whose fused heads (1,044-2,068 taps a phase) need B's slice cut into
    column blocks: one upfirdn launch, the chain's 5e-5 against the CPU."""
    x = torch.as_tensor(gen.standard_normal((2, 24000)), dtype=torch.float32)
    kw = dict(up=up, down=down, fir_taps=fir_taps,
              head_algorithm=head_algorithm)
    want = NorthStarChain(device="cpu", **kw)(x)
    before = tuf.upfirdn_banded.launches
    got = NorthStarChain(device=dev, **kw)(x.to(dev))
    torch.cuda.synchronize()
    assert tuf.upfirdn_banded.launches == before + 1
    assert _rel(got, want) < 5e-5


@pytest.mark.parametrize("channels", [1, 65535])
def test_tensor_core_upfirdn_channel_extremes(dev, gen, channels):
    table, up, down, off = _launch_geometry((4, 3))
    taps = torch.as_tensor(table, device=dev)
    x = torch.as_tensor(gen.standard_normal((channels, 96)),
                        dtype=torch.float32, device=dev)
    got = tuf.upfirdn_banded(x, taps, up, down, off, 128, "f32")
    want = tuf.upfirdn_tall(x, taps, up, down, off, 128, "f32")
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_tensor_core_upfirdn_tier_probe_at_1024_taps(dev, gen, algorithm):
    """The tier probe at the FIR's 1/1 geometry: one impulse per 1500
    samples, more than 1024 taps, so every output is one product."""
    taps = torch.as_tensor(tuf.polyphase_table_np(_lowpass(1024), 1),
                           device=dev)
    x = _impulses((2, 24000), 1500, 700, gen, dev)
    got = tuf.upfirdn_banded(x, taps, 1, 1, 0, 24000, algorithm)
    for other in ALGORITHMS:
        err = _rel(got, tuf.upfirdn_tall(x, taps, 1, 1, 0, 24000, other))
        assert (err < UPFIRDN_PROBE_TOL) == (other == algorithm), other


@pytest.mark.parametrize("nfft,hop", [(1024, 256), (2048, 512), (384, 128),
                                      (640, 128), (1536, 512),
                                      (1024, 1024), (4096, 128),
                                      (13312, 128), (16512, 128)])
@pytest.mark.parametrize("channels,n", [(1, 700), (3, 30011)])
def test_tensor_core_dft_power(dev, gen, nfft, hop, channels, n):
    """The signal's frame count, fewer frames, and more than it holds; at
    depths to 16,512 (the hi*hi sum restarted 129 times), and from q =
    nfft/hop = 104 on, where the q chunks are split over two tiles (65 and
    64 at q = 129)."""
    x = torch.as_tensor(gen.standard_normal((channels, n)),
                        dtype=torch.float32, device=dev)
    full = stft_num_frames(n, nfft, hop)
    for nf in (None, max(1, full // 3), full + 130):
        before = tsk.stft_power_dft.launches
        got = tsk.stft_power_dft(x, nfft, hop, "hann", None, nf)
        torch.cuda.synchronize()
        assert tsk.stft_power_dft.launches == before + 1
        want = tsk.stft_power_dft_plain(x, nfft, hop, "hann", None, nf)
        assert got.shape == want.shape
        assert _rel(got, want) < 1e-5, nf


def test_tensor_core_dft_power_on_an_unaligned_signal(dev, gen):
    """A signal that starts off a 16-byte boundary takes the 4-byte
    copies."""
    x = torch.as_tensor(gen.standard_normal((2, 9001)), dtype=torch.float32,
                        device=dev)
    xv = x.reshape(-1)[1:18001].reshape(2, 9000)
    assert xv.data_ptr() % 16 and xv.is_contiguous()
    got = tsk.stft_power_dft(xv, 1024, 256)
    want = tsk.stft_power_dft_plain(xv, 1024, 256)
    assert _rel(got, want) < 1e-5


# Rows beyond gridDim.y's 65,535: each wrapper launches once a run of
# 65,535 rows (_build.row_chunks). ROWS_CASES[name] = (the wrapper, its
# kernel call on a (rows, ...) input, its plain version, the input's row
# shape and dtype, the tolerance, a weight both sides are multiplied by
# before the comparison (the overlap-add norm) or None).
BIG_ROWS = 65536


def _rows_cases(dev):
    w256, w128 = STFT(256, 64).win(dev), STFT(128, 32).win(dev)
    h256, h128 = get_window_np("hann", 256), get_window_np("hann", 128)
    table, up, down, off = _launch_geometry((4, 3))
    taps = torch.as_tensor(table, device=dev)
    mfcc = _mfcc_setup(256, 24, 12, 8000.0, dev)
    mel128 = _mfcc_setup(128, 26, 13, 8000.0, dev)
    n_ola = tik.ola_norm(h256, 64, 2, 320, dev)
    n_gate = tik.periodic_norm(h256, 64, 512, dev)
    n_st = tik.ola_norm(h128, 32, stft_num_frames(256, 128, 32), 256, dev)
    n_ist = tik.ola_norm(h128, 32, 2, 160, dev)
    lp = _lowpass(16)
    os_table = tfk.os_table(_lowpass(64), dev)
    f32, c64 = torch.float32, torch.complex64
    return {
        "upfirdn_banded": (
            tuf.upfirdn_banded,
            lambda x: tuf.upfirdn_banded(x, taps, up, down, off, 128, "f32"),
            lambda x: tuf.upfirdn_tall(x, taps, up, down, off, 128, "f32"),
            (96,), f32, 1e-5, None),
        "stft_spectrum": (
            tsk.stft_spectrum, lambda x: tsk.stft_spectrum(x, 256, 64, w256),
            lambda x: tsk.stft_spectrum_plain(x, 256, 64, w256),
            (320,), f32, 5e-5, None),
        "stft_power": (
            tsk.stft_power, lambda x: tsk.stft_power(x, 256, 64, w256),
            lambda x: tsk.stft_power_plain(x, 256, 64, w256),
            (320,), f32, 5e-5, None),
        "stft_mfcc": (
            tsk.stft_mfcc,
            lambda x: tsk.stft_mfcc(x, 256, 64, *mfcc[:3], None, 1e-10,
                                    "f32"),
            lambda x: tsk.stft_mfcc_plain(x, 256, 64, mfcc[0], mfcc[1],
                                          None, 1e-10, "f32"),
            (320,), f32, 5e-5, None),
        "istft": (
            tik.istft, lambda s: tik.istft(s, 256, 64, 320, w256, n_ola),
            lambda s: tik.istft_plain(s, 256, 64, 320, w256, n_ola),
            (2, 129), c64, 5e-6, n_ola),
        "stft_gate_packed": (
            tik.stft_gate_packed,
            lambda x: tik.stft_gate_packed(x, 256, 64, 0.0, w256, n_gate),
            lambda x: tik.stft_gate_packed_plain(x, 256, 64, 0.0, w256,
                                                 n_gate),
            (512,), f32, 5e-6, n_gate),
        "stft_spectrum_stockham": (
            tstk.stft_spectrum_stockham,
            lambda x: tstk.stft_spectrum_stockham(x, 128, 32, w128),
            lambda x: tstk.stft_spectrum_stockham_plain(x, 128, 32, w128),
            (160,), f32, 5e-5, None),
        "stft_power_stockham": (
            tstk.stft_power_stockham,
            lambda x: tstk.stft_power_stockham(x, 128, 32, w128),
            lambda x: tstk.stft_power_stockham_plain(x, 128, 32, w128),
            (160,), f32, 5e-5, None),
        "stft_mel_stockham": (
            tstk.stft_mel_stockham,
            lambda x: tstk.stft_mel_stockham(x, 128, 32, *mel128[:3]),
            lambda x: tstk.stft_mel_stockham_plain(x, 128, 32, mel128[0],
                                                   mel128[1]),
            (160,), f32, 5e-5, None),
        "stft_gate_stockham": (
            tstk.stft_gate_stockham,
            lambda x: tstk.stft_gate_stockham(x, 128, 32, w128, n_st, 0.0),
            lambda x: tstk.stft_gate_stockham_plain(x, 128, 32, w128, n_st,
                                                    0.0),
            (256,), f32, 5e-6, n_st),
        "istft_stockham": (
            tstk.istft_stockham,
            lambda s: tstk.istft_stockham(s, 128, 32, 160, w128, n_ist,
                                          rfft=True),
            lambda s: tstk.istft_stockham_plain(s, 128, 32, 160, w128, n_ist,
                                                rfft=True),
            (2, 65), c64, 5e-6, n_ist),
        "stft_power_dft": (
            tsk.stft_power_dft, lambda x: tsk.stft_power_dft(x, 256, 128),
            lambda x: tsk.stft_power_dft_plain(x, 256, 128),
            (384,), f32, 1e-5, None),
        "fir_direct": (
            tfk.fir_direct, lambda x: tfk.fir_direct(lp, x),
            lambda x: tfk.fir_direct_plain(lp, x), (64,), f32, FIR_TOL,
            None),
        "resample_poly_kernel": (
            tfk.resample_poly_kernel,
            lambda x: tfk.resample_poly_kernel(x, 4, 3),
            lambda x: tfk.resample_poly_plain(x, 4, 3), (64,), f32,
            POLY_TOL, None),
        "fir_os": (
            tfk.fir_os, lambda x: tfk.fir_os(x, os_table, 64),
            lambda x: tfk.fir_os_plain(x, os_table, 64), (300,), f32,
            OS_TOL, None),
    }


ROWS_WRAPPERS = ("upfirdn_banded", "stft_spectrum", "stft_power",
                 "stft_mfcc", "istft", "stft_gate_packed",
                 "stft_spectrum_stockham", "stft_power_stockham",
                 "stft_mel_stockham", "stft_gate_stockham",
                 "istft_stockham", "stft_power_dft", "fir_direct",
                 "resample_poly_kernel", "fir_os")


@pytest.mark.parametrize("name", ROWS_WRAPPERS)
def test_wrappers_launch_over_more_than_65535_rows(dev, gen, name):
    """65,536 rows: two launches (65,535 rows and 1), the same bits as the
    wrapper's own calls on rows [0, 65535) and [65535, 65536), and the
    plain version's values on the last rows."""
    wrapper, fast, plain, shape, dtype, tol, weight = _rows_cases(dev)[name]
    torch.manual_seed(int(gen.integers(1 << 30)))
    x = torch.randn((BIG_ROWS,) + shape, dtype=dtype, device=dev)
    if x.is_complex():   # a one-sided spectrum: real DC and Nyquist bins
        x[..., 0].imag.zero_()
        x[..., -1].imag.zero_()
    before = wrapper.launches
    got = fast(x)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    head, tail = fast(x[:65535]), fast(x[65535:])
    torch.cuda.synchronize()
    assert wrapper.launches == before + 4
    assert got.shape[0] == BIG_ROWS
    assert torch.equal(got[:65535], head) and torch.equal(got[65535:], tail)
    want = plain(x[-3:])
    last = got[-3:]
    if weight is not None:
        last, want = last * weight, want * weight
    if last.is_complex():
        assert _cplx_rel(last, want) < tol
    else:
        assert _rel(last, want) < tol


# Savitzky-Golay through kernel 1 (the banded upfirdn at 1/1, offset
# wl - 1), at the window lengths of its range, against its plain version
# (the shift-add correlation) at the upfirdn limit, 1e-5 of max |y|
@pytest.mark.parametrize("wl", [5, 11, 31, 101, 257])
@pytest.mark.parametrize("deriv", [0, 1])
def test_savgol_runs_the_banded_kernel(dev, gen, wl, deriv):
    x = torch.as_tensor(gen.standard_normal((3, 20011)), dtype=torch.float32,
                        device=dev)
    before = [f.launches for f in _counters()]
    got = tsg.savgol_filter(x, wl, 3, deriv)
    torch.cuda.synchronize()
    after = [f.launches for f in _counters()]
    assert [a - b for a, b in zip(after, before)] == [
        1 if f is tuf.upfirdn_banded else 0 for f in _counters()]
    xp = tsg._pad(x, wl // 2, "reflect")
    w = torch.as_tensor(tsg.savgol_coeffs_np(wl, 3, deriv),
                        dtype=torch.float32, device=dev)
    want = tsg.correlate_plain(xp, w, x.shape[-1])
    assert _rel(got, want) < 1e-5
    assert _rel(got, tsg.savgol_filter(x.cpu(), wl, 3, deriv)) < 1e-5


def _budget(monkeypatch, nbytes):
    """Lower the upfirdn plan's shared-memory budget (and drop its cached
    searches), so that no layout fits a block."""
    tmp._upfirdn_search.cache_clear()
    monkeypatch.setattr(tmp, "SMEM_BYTES", nbytes)


def test_upfirdn_fits_agrees_with_the_plan_and_the_kernel(dev, gen,
                                                          monkeypatch):
    x = torch.as_tensor(gen.standard_normal((2, 5000)), dtype=torch.float32,
                        device=dev)
    table = tuf.polyphase_table(np.hanning(31), 1, dev)
    try:
        for small in (False, True):
            if small:
                _budget(monkeypatch, 1024)
            for algorithm in ALGORITHMS:
                fits = tmp.upfirdn_fits(1, 1, 31, 30, algorithm)
                assert fits == (not small)
                if fits:
                    tmp.upfirdn_plan(1, 1, 31, 30, algorithm)
                    y = tuf.upfirdn_banded(x, table, 1, 1, 30, 5000,
                                           algorithm)
                    assert _rel(y, tuf.upfirdn_tall(x, table, 1, 1, 30, 5000,
                                                    algorithm)) < 1e-5
                    continue
                with pytest.raises(ValueError):
                    tmp.upfirdn_plan(1, 1, 31, 30, algorithm)
                with pytest.raises(ValueError):
                    tuf.upfirdn_banded(x, table, 1, 1, 30, 5000, algorithm)
    finally:
        tmp._upfirdn_search.cache_clear()


def _routed_calls():
    """The calls the JAX package runs on XLA, each as (name, call on a
    tensor, tolerance of scale): the port's "torch" route. The inverse's
    spectrum is made on the CPU: the forward kernel takes 1024/384. The
    gates' outputs are compared before their norm is divided out
    (``_gate_rel``)."""
    return [
        ("STFT(64, 16).process", lambda x, d: STFT(64, 16).process(x), 5e-5),
        ("STFT(64, 16).power", lambda x, d: STFT(64, 16).power(x), 5e-5),
        ("STFT(1000, 250).spectrogram",
         lambda x, d: STFT(1000, 250).spectrogram(x), 5e-5),
        ("complex STFT(1024, 256).process",
         lambda x, d: STFT(1024, 256).process(x.to(torch.complex64)), 5e-5),
        ("STFT(1024, 384).reconstruct", lambda x, d: STFT(1024, 384)
         .reconstruct(STFT(1024, 384).process(x.cpu(), rfft=True).to(x.device),
                      x.shape[-1], rfft=True)[:, 1024:-1024], 5e-6),
        ("SpectralGate(128, 128)", lambda x, d: SpectralGate(
            128, 128, device=d)(x) * _gate_norm(128, 128, x.shape[-1], d),
         5e-6),
        ("SpectralGate(128, 24)", lambda x, d: SpectralGate(
            128, 24, device=d)(x) * _gate_norm(128, 24, x.shape[-1], d),
         5e-6),
        ("MFCCFrontend(128, 24)", lambda x, d: MFCCFrontend(
            128, 24, device=d)(x), 5e-4),
    ]


@pytest.mark.parametrize("index", range(8))
def test_xla_routes_run_on_card(dev, gen, index):
    """Each call of the "torch" route on the card: its CPU result, and no
    kernel launched (MFCCs: 5e-4 absolute)."""
    name, call, tol = _routed_calls()[index]
    x = torch.as_tensor(gen.standard_normal((2, 9000)), dtype=torch.float32)
    before = [f.launches for f in _counters()]
    got = call(x.to(dev), dev)
    torch.cuda.synchronize()
    assert [f.launches for f in _counters()] == before, name
    want = call(x, "cpu")
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    if name.startswith("MFCC"):
        assert (got.cpu() - want).abs().max().item() < tol, name
    else:
        assert _rel(got, want) < tol, name


def test_fused_head_torch_route_on_card(dev, gen, monkeypatch):
    """A head the plan finds no layout for (a 1 KiB budget) runs
    upfirdn_tall on the card, launches nothing and gives the CPU result
    (the resampler limit, 1e-5 of max |y|)."""
    x = torch.as_tensor(gen.standard_normal((2, 9000)), dtype=torch.float32)
    h = NorthStarChain(device="cpu").fir_coeffs
    try:
        _budget(monkeypatch, 1024)
        before = [f.launches for f in _counters()]
        got = trs.fir_resample_fused(h, x.to(dev), 4, 3)
        torch.cuda.synchronize()
        assert [f.launches for f in _counters()] == before
        assert _rel(got, trs.fir_resample_fused(h, x, 4, 3)) < 1e-5
    finally:
        tmp._upfirdn_search.cache_clear()


def test_reconstruct_off_the_lattice_is_deterministic_on_card(dev, gen):
    """1024/384 takes the dense overlap-add: two calls, the same bits."""
    x = torch.as_tensor(gen.standard_normal((4, 48000)), dtype=torch.float32,
                        device=dev)
    plan = STFT(1024, 384)
    spec = plan.process(x, rfft=True)
    a = plan.reconstruct(spec, 48000, rfft=True)
    b = plan.reconstruct(spec, 48000, rfft=True)
    assert torch.equal(a, b)
    assert (a - x)[:, 1024:-1024].abs().max().item() < 3e-5


# ---- the analysis, IIR and streaming tier: plain PyTorch on the card ----

def _analysis_calls():
    """(name, call of a CPU or CUDA tensor, tolerance of scale)."""
    from vv_dsp_tpu_torch.ops import czt as tczt
    from vv_dsp_tpu_torch.ops import envelope as tenv
    from vv_dsp_tpu_torch.ops import hilbert as thil
    from vv_dsp_tpu_torch.ops import iir as tiir
    w = np.exp(-2j * np.pi / 4096)
    zoom = tczt.czt_params_for_freq_range(800.0, 1200.0, 512, 48000.0)
    sos4, sos18 = tiir.butter_sos(4, 0.2), tiir.butter_sos(18, 0.2)
    return [
        ("hilbert_analytic", thil.hilbert_analytic, 5e-5),
        ("envelope", thil.envelope, 5e-5),
        ("czt dft", lambda x: tczt.czt(x[..., :4096], 4096, w), 5e-5),
        ("czt zoom", lambda x: tczt.czt(x, 512, *zoom), 5e-5),
        ("cepstrum_real", tenv.cepstrum_real, 5e-5),
        ("lpc 16", lambda x: tenv.lpc(x, 16)[0], 1e-4),
        ("iir_apply block", lambda x: tiir.iir_apply(sos4, x), 1e-5),
        ("iir_apply scan", lambda x: tiir.iir_apply(sos18, x), 1e-5),
        ("iir_apply short", lambda x: tiir.iir_apply(sos4, x[..., :1000]),
         1e-5),
        ("filtfilt_sos", lambda x: tiir.filtfilt_sos(sos4, x), 1e-5),
        ("lfilter order 2", lambda x: tiir.lfilter(
            [0.2, 0.3, 0.1], [1.0, -0.5, 0.2], x), 1e-5),
    ]


@pytest.mark.parametrize("index", range(11))
def test_analysis_and_iir_on_card(dev, gen, index):
    """Each call on the card against its CPU result, launching no kernel
    (a plain PyTorch tier: cuFFT, cuBLAS and elementwise ops)."""
    name, call, tol = _analysis_calls()[index]
    x = torch.as_tensor(gen.standard_normal((2, 20000)), dtype=torch.float32)
    before = [f.launches for f in _counters()]
    got = call(x.to(dev))
    torch.cuda.synchronize()
    assert [f.launches for f in _counters()] == before, name
    want = call(x)
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    assert got.device.type == "cuda"
    assert _rel(got, want) < tol, name


def test_streams_on_card(dev, gen, tmp_path):
    """StreamingNorthStar at a small configuration on the card against
    the CPU (1e-4 of max|MFCC|), no kernel launched; its checkpoint loads
    onto the card and resumes bit for bit."""
    from vv_dsp_tpu_torch.models import StreamingNorthStar
    from vv_dsp_tpu_torch.utils import checkpoint as tck
    chain = StreamingNorthStar(fir_taps=64, nfft=256, hop=64, n_mels=32,
                               n_mfcc=13)
    x = torch.as_tensor(gen.standard_normal((2, 6 * 768)),
                        dtype=torch.float32)
    before = [f.launches for f in _counters()]
    got, state = chain.process_blocks(chain.init((2,), device=dev), x.to(dev),
                                      768)
    tail = chain.flush(state)
    torch.cuda.synchronize()
    assert [f.launches for f in _counters()] == before
    want, cpu_state = chain.process_blocks(chain.init((2,), device="cpu"),
                                           x, 768)
    scale = want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() < 1e-4 * scale
    assert ((tail.cpu() - chain.flush(cpu_state)).abs().max().item()
            < 1e-4 * scale)
    path = str(tmp_path / "state.npz")
    tck.save(path, state)
    restored = tck.load(path, chain.init((2,), device=dev))
    assert all(v.device.type == "cuda" for v in restored.values())
    a, _ = chain.process(state, x[:, :768].to(dev))
    b, _ = chain.process(restored, x[:, :768].to(dev))
    assert torch.equal(a, b)


def test_entry_points_take_strided_input_on_card(dev, gen):
    """A strided view (a slice of every other sample, or the transposed
    output of an einsum) reaches the kernels as contiguous rows: each entry
    point gives the result of the same values made contiguous."""
    from vv_dsp_tpu_torch.ops import resample as trs_
    x = torch.as_tensor(gen.standard_normal((2, 40000)), dtype=torch.float32,
                        device=dev)[:, ::2]
    assert not x.is_contiguous()
    xc = x.contiguous()
    h = NorthStarChain(device="cpu").fir_coeffs
    calls = (lambda v: STFT(1024, 256).power(v),
             lambda v: STFT(1024, 256).process(v, rfft=True),
             lambda v: STFT(128, 32).power(v),
             lambda v: tmel.mfcc_stft(v, 1024, 256, 26, 13, 16000.0),
             lambda v: trs_.fir_resample_fused(h, v, 4, 3, algorithm="f32"),
             lambda v: NorthStarChain(device=dev)(v))
    for call in calls:
        got, want = call(x), call(xc)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# ---- the sharded path and the WAV I/O on the card ----

def _card_mesh(shape, dev):
    from vv_dsp_tpu_torch import parallel as tpar
    return tpar.make_mesh(*shape, devices=[dev] * 8)


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_sharded_chain_and_gate_on_card(dev, gen, shape):
    """NorthStarChain and SpectralGate.apply_sharded on 8 shards of one
    card against the dense port: the chain at 2e-3 of scale (fused and
    staged halos), fused against staged at 2e-4 (tests/test_parallel.py's
    limits), the gate on a tone probe (every bin clear of the threshold)
    at 5e-5 of scale; each runs the full-nfft spectrum kernel once a
    shard, c*b launches a call."""
    mesh = _card_mesh(shape, dev)
    c, b = shape
    chain = NorthStarChain(device=dev)
    x = torch.as_tensor(gen.standard_normal((2, 8 * 2048 * 3)),
                        dtype=torch.float32, device=dev)
    dense = chain(x)
    outs = {}
    for fused in (True, False):
        before = tstk.stft_spectrum_stockham.launches
        outs[fused] = chain.apply_sharded(x, mesh, fuse_halos=fused).gather()
        torch.cuda.synchronize()
        assert tstk.stft_spectrum_stockham.launches - before == c * b
    scale = dense.abs().max().item()
    nf = dense.shape[-2]
    for got in outs.values():
        assert got.device == dev
        assert (got[:, :nf] - dense).abs().max().item() < 2e-3 * scale
    assert (outs[True] - outs[False]).abs().max().item() < 2e-4 * scale
    n = 24000
    t = np.arange(n)
    probe = sum(a * np.cos(2 * np.pi * k * t / 1024 + p)
                for k, a, p in ((40, 1.0, 0.3), (97, 0.7, 1.1),
                                (211, 0.02, 2.0)))
    probe = torch.as_tensor(np.stack([probe, probe[::-1].copy()]) + 1e-4
                            * gen.standard_normal((2, n)),
                            dtype=torch.float32, device=dev)
    gate = SpectralGate(device=dev)
    before = tstk.stft_spectrum_stockham.launches
    got = gate.apply_sharded(probe, mesh).gather()
    torch.cuda.synchronize()
    assert tstk.stft_spectrum_stockham.launches - before == c * b
    want = gate(probe)
    assert got.shape == want.shape
    assert _rel(got, want) < 5e-5


def test_sharded_stft_on_card_matches_cpu(dev, gen):
    """stft_process_sharded on the card (the kernel on each shard, c*b
    launches) equals the same call on a CPU mesh (the plain version);
    hop not dividing nfft takes the gather framing, launching nothing."""
    from vv_dsp_tpu_torch import parallel as tpar
    x = torch.as_tensor(gen.standard_normal((4, 16384)), dtype=torch.float32)
    cpu = tpar.make_mesh(2, 4, devices=[torch.device("cpu")] * 8)
    before = tstk.stft_spectrum_stockham.launches
    got = tpar.stft_process_sharded(x.to(dev), 1024, 256,
                                    _card_mesh((2, 4), dev))
    torch.cuda.synchronize()
    assert tstk.stft_spectrum_stockham.launches - before == 8
    want = tpar.stft_process_sharded(x, 1024, 256, cpu).gather()
    assert _cplx_rel(got.gather(), want) < 5e-5
    before = tstk.stft_spectrum_stockham.launches
    got = tpar.stft_process_sharded(x[:, :10240].to(dev), 512, 160,
                                    _card_mesh((1, 8), dev), pad=True)
    assert tstk.stft_spectrum_stockham.launches == before
    want = tpar.stft_process_sharded(
        x[:, :10240], 512, 160,
        tpar.make_mesh(1, 8, devices=[torch.device("cpu")] * 8), pad=True)
    assert _cplx_rel(got.gather(), want.gather()) < 5e-5


def test_make_mesh_takes_the_cards_and_dryrun(dev):
    from vv_dsp_tpu_torch import parallel as tpar
    from vv_dsp_tpu_torch.parallel.dryrun import dryrun_multichip
    mesh = tpar.make_mesh()
    assert mesh.shape["block"] == torch.cuda.device_count()
    assert all(d.type == "cuda" for row in mesh.devices for d in row)
    dryrun_multichip(8)


def test_write_wav_takes_a_card_tensor(dev, gen, tmp_path):
    from vv_dsp_tpu_torch import io as tio
    y = torch.as_tensor(gen.uniform(-0.9, 0.9, (2, 4801)),
                        dtype=torch.float32, device=dev)
    p = tmp_path / "card.wav"
    tio.write_wav(p, y, 48000, format=0)
    back, sr = tio.read_wav(p)
    assert sr == 48000 and back.device.type == "cpu"
    assert torch.equal(back, y.cpu())


def test_fused_head_takes_the_jax_arguments_on_card(dev, gen):
    """fir_resample_fused with JAX's (h, x, up, down, group, algorithm):
    the positional (h, x, 4, 3, None, "bf16") launches the banded kernel
    at bf16, and group= (which only the "torch" route reads) changes no
    value; each against its CPU plain version at the resampler limit, 1e-5
    of max |y| (the same products at the tier, another summation order)."""
    x = torch.as_tensor(gen.standard_normal((2, 9000)), dtype=torch.float32)
    h = NorthStarChain(device="cpu").fir_coeffs
    for args, kwargs in (((None, "bf16"), {}), ((), {"group": 7}),
                         ((5,), {"algorithm": "f32"})):
        before = tuf.upfirdn_banded.launches
        got = trs.fir_resample_fused(h, x.to(dev), 4, 3, *args, **kwargs)
        torch.cuda.synchronize()
        assert tuf.upfirdn_banded.launches == before + 1
        want = trs.fir_resample_fused(h, x, 4, 3, *args, **kwargs)
        assert got.shape == want.shape == (2, 12000)
        assert _rel(got, want) < 1e-5, (args, kwargs)


def test_dump_fft_tool_on_card(dev, gen, tmp_path, capsys):
    """A CLI tool runs on the card by default: dump_fft --type r2c against
    its --cpu run at 5e-5 of scale."""
    from vv_dsp_tpu_torch.tools import dump_fft
    p = tmp_path / "x.txt"
    p.write_text("".join(f"{v:.9g}\n" for v in gen.random(256)))
    argv = ["--type", "r2c", "--dir", "fwd", "-n", "256", "--infile", str(p)]
    runs = []
    for extra in ([], ["--cpu"]):
        capsys.readouterr()
        assert dump_fft.main(argv + extra) == 0
        out = capsys.readouterr().out
        runs.append(np.asarray([[float(v) for v in line.split(",")]
                                for line in out.splitlines()]))
    assert runs[0].shape == runs[1].shape == (129, 2)
    assert np.abs(runs[0] - runs[1]).max() < 5e-5 * np.abs(runs[1]).max()
