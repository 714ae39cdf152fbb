"""The port's example twins (``vv_dsp_tpu_torch.examples``) on the CPU, at
small sizes, against the JAX package's same calls on the same numpy input
made in this process (the JAX example scripts are not run: their
module-level ``jax.config`` calls can conflict inside one test process).
Each twin runs through ``main(["--cpu", ...])``; its ``run`` is wrapped so
the test also reads the values it printed. Tolerances are those of the
port's existing tests of each call:

- stft_pipeline: the SNRs to 0.1 dB (printed at 0.1 dB), the gated signal
  at 5e-6 of scale (test_torch_synthesis.py's SpectralGate test; the tone
  clears the threshold by far in every frame);
- wav_mfcc and serving: the MFCC shapes, c0's mean and (serving) every
  MFCC at 5e-4 absolute (test_torch_synthesis.py's MFCCFrontend test);
  wav_mfcc's MFCCs against a float64 oracle (see the test);
- filter: FIR, filtfilt and the Butterworth at 1e-5 of max|y|, the
  streamed FIR equal to the whole-signal one to 1e-6;
- precision: each tier's error against "highest" under its tier's bound
  (0 at highest, 1e-4 for bf16x3, 1e-2 for bf16: the unit roundoffs 2^-17
  and 2^-9 of the tiers' products through the log-mel and DCT) and the
  "highest" MFCCs against JAX at 5e-4 absolute. The JAX package runs every
  tier at float32 on the CPU, so its tiers are no yardstick;
- multichip: the sharded FIR and IIR against the port's dense calls and
  the JAX package's at the JAX suite's allclose tolerances (2e-5, 1e-4),
  the sharded chain's n // hop frames a shard (the JAX dense chain's count
  and more) and the JAX dense chain's frames at 2e-3 of scale
  (tests/test_parallel.py).
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vv_dsp_tpu import streaming as jstream
from vv_dsp_tpu.io import read_wav as j_read_wav
from vv_dsp_tpu.io import write_wav as j_write_wav
from vv_dsp_tpu.models import MFCCFrontend as JFrontend
from vv_dsp_tpu.models import NorthStarChain as JChain
from vv_dsp_tpu.models import SpectralGate as JGate
from vv_dsp_tpu.ops import fir as jfir
from vv_dsp_tpu.ops import iir as jiir

NAMES = ("filter", "multichip", "precision", "serving", "stft_pipeline",
         "wav_mfcc")
MFCC_ATOL = 5e-4


def _module(name):
    return importlib.import_module(
        f"vv_dsp_tpu_torch.examples.{name}_example")


def _main(name, argv, capsys, monkeypatch):
    """(stdout lines, the values run returned) of main(["--cpu", *argv])."""
    mod = _module(name)
    seen = []
    real = mod.run
    monkeypatch.setattr(mod, "run",
                        lambda *a, **k: seen.append(real(*a, **k)))
    capsys.readouterr()
    assert mod.main(["--cpu", *argv]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(seen) == 1
    return out, seen[0]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _mfcc64(x, nfft, hop, n_mels, n_mfcc, sample_rate, lifter):
    """MFCCFrontend in float64 numpy (chip_smoke.py's frontend oracle):
    framed rfft power -> HTK mel -> log -> liftered DCT-II, frames as the
    front-end counts them."""
    from vv_dsp_tpu_torch.models import frontend_params
    p = frontend_params(nfft, n_mels, n_mfcc, sample_rate, lifter)
    n = x.shape[-1]
    nf = 1 + (n - nfft + hop) // hop
    xp = np.pad(np.asarray(x, np.float64),
                ((0, 0), (0, (nf - 1) * hop + nfft - n)))
    frames = np.stack([xp[:, i * hop:i * hop + nfft] for i in range(nf)], 1)
    pw = np.abs(np.fft.rfft(frames * p["window"], axis=-1)) ** 2
    return np.log(pw @ p["mel_fb"].T + 1e-10) @ p["dct_lift"].T


def test_stft_pipeline(capsys, monkeypatch):
    out, res = _main("stft_pipeline", [], capsys, monkeypatch)
    fs, n = 48000, 48000
    t = np.arange(n) / fs
    clean = 0.8 * np.sin(2 * np.pi * 440.0 * t)
    noisy = clean + 0.05 * np.random.default_rng(0).standard_normal(n)
    want = np.asarray(JGate(1024, 256, 0.1)(jnp.asarray(
        noisy[None, :], dtype=jnp.float32)))[0]
    seg = slice(1024, n - 1024)
    snr_out = 10 * np.log10(np.mean(clean[seg] ** 2)
                            / np.mean((want[seg] - clean[seg]) ** 2))
    words = out[-1].split()
    assert out[-1].startswith("SNR in: ") and len(words) == 8
    assert abs(float(words[2]) - res["snr_in"]) <= 0.05 + 1e-9
    assert abs(float(words[6]) - snr_out) <= 0.1
    assert abs(res["snr_out"] - snr_out) <= 0.1
    assert res["y"].shape == (n,)
    assert _rel(res["y"], want) < 5e-6


def test_wav_mfcc(capsys, monkeypatch, tmp_path):
    out, res = _main("wav_mfcc", [], capsys, monkeypatch)
    fs = 16000
    t = np.arange(fs) / fs
    sig = (0.5 * np.sin(2 * np.pi * 220 * t)
           + 0.25 * np.sin(2 * np.pi * 660 * t)).astype(np.float32)
    path = str(tmp_path / "x.wav")
    j_write_wav(path, sig, fs, format=16)
    audio, sr = j_read_wav(path)
    want = np.asarray(JFrontend(512, 256, 26, 13, float(sr), lifter=22.0)(
        jnp.asarray(audio)))
    assert out[0].startswith("wrote ") and out[0].endswith(
        ": 16000 Hz, 1 ch, 16-bit, 16000 frames")
    assert out[1] == (f"MFCC: {want.shape} c0 mean: {res['c0_mean']}")
    assert res["feats"].shape == want.shape == (1, 62, 13)
    assert abs(res["c0_mean"] - float(np.mean(want[..., 0]))) < MFCC_ATOL
    # two tones over 16-bit quantization noise: the bands between them hold
    # ~1e-8 of power (1e-11 of the peak band), where float32 FFT noise moves
    # the log by ~0.1 in both packages (JAX 0.124, the port 0.133 from
    # float64, 3e-4 of scale), so each is held to the float64 oracle, the
    # port within twice JAX's own distance
    oracle = _mfcc64(audio, 512, 256, 26, 13, float(sr), 22.0)
    jax_err = np.abs(want - oracle).max()
    assert np.abs(res["feats"] - oracle).max() <= 2 * jax_err


def test_serving(capsys, monkeypatch, tmp_path):
    from vv_dsp_tpu_torch.examples.serving_example import make_corpus
    out, res = _main("serving", ["--files", "4", "--seconds", "0.25"],
                     capsys, monkeypatch)
    audio = np.stack([j_read_wav(p)[0][0]
                      for p in make_corpus(str(tmp_path), 4, 0.25, 48000)])
    want = np.asarray(JFrontend(1024, 256, 40, 13, 48000.0)(
        jnp.asarray(audio)))
    assert out[0] == f"batch of 4: features {want.shape}"
    assert out[1].startswith("served 48000 samples in ")
    assert out[1].endswith("decode overlapped) on cpu")
    assert res["samples"] == 4 * 12000 and len(res["feats"]) == 1
    np.testing.assert_allclose(res["feats"][0], want, rtol=0,
                               atol=MFCC_ATOL)


def test_filter(capsys, monkeypatch):
    out, res = _main("filter", [], capsys, monkeypatch)
    taps, n = 33, 128
    h = jfir.design_lowpass(taps, 0.2, "hamming")
    x = jnp.asarray(np.where(np.arange(n) % 10 < 5, 1.0, -1.0),
                    dtype=jnp.float32)
    y = np.asarray(jfir.fir_apply(h, x))
    state = jstream.fir_stream_init(h)
    blocks = []
    for i in range(0, n, 32):
        blk, state = jstream.fir_stream_process(h, state, x[i:i + 32])
        blocks.append(np.asarray(blk))
    yzp = np.asarray(jfir.filtfilt_fir(h, x))
    yb = np.asarray(jiir.iir_apply(jiir.butter_sos(4, 0.2), x))
    assert out[0].startswith("y[0..4]: [")
    assert _rel(res["y"], y) < 1e-5
    assert res["stream_diff"] <= 1e-6
    assert out[1] == f"streaming max |diff|: {res['stream_diff']}"
    assert np.abs(np.concatenate(blocks) - y).max() <= 1e-6
    assert _rel(res["filtfilt"], yzp) < 1e-5
    assert _rel(res["butter"], yb) < 1e-5
    assert _rel(res["filtfilt_rms"], np.sqrt(np.mean(yzp ** 2))) < 1e-5
    assert _rel(res["butter_rms"], np.sqrt(np.mean(yb ** 2))) < 1e-5
    assert out[2] == (f"filtfilt rms: {res['filtfilt_rms']} butter rms: "
                      f"{res['butter_rms']}")


def test_precision(capsys, monkeypatch):
    from vv_dsp_tpu_torch import config
    out, res = _main("precision", [], capsys, monkeypatch)
    assert config.get_matmul_precision() == "highest"
    errors = res["errors"]
    assert errors["highest"] == 0.0
    assert 0.0 < errors["high"] < 1e-4
    assert 0.0 < errors["default"] < 1e-2
    for tier in ("highest", "high", "default"):
        assert f"MFCC @ {tier:8s}: max rel err vs highest = " \
               f"{errors[tier]:.2e}" in out
    x = np.random.default_rng(0).standard_normal((1, 48000))
    want = np.asarray(JFrontend()(jnp.asarray(x, dtype=jnp.float32)))
    assert res["ref"].shape == want.shape
    np.testing.assert_allclose(res["ref"], want, rtol=0, atol=MFCC_ATOL)


def test_multichip(capsys, monkeypatch):
    out, res = _main("multichip", [], capsys, monkeypatch)
    assert out[0] == "mesh: {'channel': 1, 'block': 8} over cpu"
    assert res["fir_err"] < 2e-5 and res["iir_err"] < 1e-4
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (4, 8 * 6144)), dtype=jnp.float32)
    np.testing.assert_allclose(
        res["fir"], jfir.fir_apply(jfir.design_lowpass(255, 0.25), x),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        res["iir"], jiir.iir_apply(jiir.butter_sos(4, 0.2), x),
        rtol=1e-4, atol=1e-4)
    want = np.asarray(JChain(fir_taps=128, nfft=512, hop=128, n_mels=40,
                             n_mfcc=13)(x))
    # n // hop frames a shard, as the JAX sharded chain (the dense count
    # stops where the last frame fits, tests/test_torch_parallel.py)
    nf = want.shape[-2]
    assert res["feats"].shape == (4, 8 * 6144 * 4 // 3 // 128, 13)
    assert res["feats"].shape[:1] + res["feats"].shape[2:] == \
        want.shape[:1] + want.shape[2:] and nf <= res["feats"].shape[1]
    assert out[-1] == f"sharded MFCC features: {res['feats'].shape}"
    np.testing.assert_allclose(res["feats"][:, :nf], want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_no_gpu_without_cpu_flag_fails(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the examples run on it")
    capsys.readouterr()
    assert _module(name).main([]) == 1
    assert capsys.readouterr() == ("", "no CUDA device; pass --cpu\n")


def test_examples_live_in_the_port():
    """The twins keep the JAX scripts' file names; examples/ is untouched
    by them."""
    here = os.path.dirname(os.path.abspath(__file__))
    jax_dir = os.path.join(os.path.dirname(here), "examples")
    port_dir = os.path.dirname(_module("filter").__file__)
    assert sorted(f for f in os.listdir(jax_dir) if f.endswith(".py")) == \
        sorted(f"{n}_example.py" for n in NAMES)
    for name in NAMES:
        assert os.path.isfile(os.path.join(port_dir, f"{name}_example.py"))
