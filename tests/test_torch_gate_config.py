"""The benchmark's ``spectral_gate_1024_256`` configuration on the CPU: the
port's ``SpectralGate`` (its plain path) against the configuration's plain
float64 reference on the tone probe, that reference against float64 NumPy
written here, the probe's distance from the gate's threshold at the cell's
own length, the entry's prepared input against the reference's probe, the
reference's imports, and planted faults against the cell's limit."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from h100bench.manifest import BENCH_DIR, ROOT, Cell
from h100bench.reference import spectral_gate_1024_256 as ref
from vv_dsp_tpu_torch.models import SpectralGate
from vv_dsp_tpu_torch.models.pipeline import gate_route
from vv_dsp_tpu_torch.ops import istft_kernels as tik
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops import stockham_kernels as tstk
from vv_dsp_tpu_torch.ops.framing import stft_num_frames
from torch_one_thread import one_thread

FIELDS = json.loads((BENCH_DIR / "configs" / "spectral_gate_1024_256.json"
                     ).read_text())
N = FIELDS["batch_samples"]
FIELDS = FIELDS["fields"]
# small rows for the pipeline's tests, the fade cut to fit them
SMALL = dict(FIELDS, probe_fade=1024)
LIMIT = ref.LIMITS["call"]["err_of_scale"]


def _noise(c: int, n: int, seed: int) -> torch.Tensor:
    return torch.randn((c, n), generator=torch.Generator().manual_seed(seed))


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 3, 2**33 + 5])
def test_port_matches_the_reference(seed):
    x = _noise(2, 8192, seed)
    got = SpectralGate(device="cpu")(ref.probe(SMALL, x))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _err(got, ref.call(SMALL, x)) < 2e-5


def _padded_gate(gate: SpectralGate, x: torch.Tensor) -> torch.Tensor:
    """SpectralGate through a padded copy of its input: F.pad by the edge
    pad, the plain spectrum and gated inverse (or the full-nfft plain gate)
    of the padded rows, the crop."""
    nfft, hop, t = gate.nfft, gate.hop, gate.threshold
    pad, n = gate.edge_pad, x.shape[-1]
    xp = torch.nn.functional.pad(x, (pad, pad))
    n_pad = xp.shape[-1]
    norm = tik.ola_norm(gate.window_np, hop,
                        stft_num_frames(n_pad, nfft, hop), n_pad, x.device)
    if gate_route(nfft, hop) == "full_nfft":
        out = tstk.stft_gate_stockham_plain(xp, nfft, hop, gate.window, norm,
                                            t)
    else:
        spec = tsk.stft_spectrum_plain(xp, nfft, hop, gate.window,
                                       onesided=True)
        out = tik.istft_plain(spec, nfft, hop, n_pad, gate.window, norm, t)
    return out[..., pad:pad + n]


@pytest.mark.parametrize("nfft,hop", [(1024, 256), (256, 64), (128, 24),
                                      (128, 32)])
def test_gate_output_and_grad_match_the_padded_input(nfft, hop):
    """SpectralGate on a CPU input, whose spectrum takes the edge pad as an
    argument on the split and torch routes, against the same gate on a
    padded copy: the output and x.grad bit for bit, on every route."""
    gate = SpectralGate(nfft, hop, 0.1, device="cpu")
    x = _noise(2, 5000, 29)
    weight = _noise(2, 5000, 31)
    with one_thread():
        xa = x.clone().requires_grad_(True)
        got = gate(xa)
        (got * weight).sum().backward()
        xb = x.clone().requires_grad_(True)
        want = _padded_gate(gate, xb)
        (want * weight).sum().backward()
    assert torch.equal(got, want)
    assert torch.equal(xa.grad, xb.grad) and xa.grad.abs().max() > 0


def _numpy_gate(p: np.ndarray, f: dict) -> np.ndarray:
    """Edge pad, frames by a loop, rfft, the gate, irfft, overlap-add and
    the w^2 norm by loops, the crop: float64 NumPy."""
    nfft, hop, t = f["nfft"], f["hop"], f["threshold"]
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nfft) / (nfft - 1))
    pad = nfft - hop
    c, n = p.shape
    xp = np.pad(p, ((0, 0), (pad, pad)))
    nf = 1 + (xp.shape[1] - nfft + hop) // hop
    total = (nf - 1) * hop + nfft
    xp = np.pad(xp, ((0, 0), (0, total - xp.shape[1])))
    out = np.zeros((c, total))
    norm = np.zeros(total)
    for i in range(nf):
        s = slice(i * hop, i * hop + nfft)
        spec = np.fft.rfft(xp[:, s] * w, axis=-1)
        power = np.abs(spec) ** 2
        spec[power < t * t * power.max(axis=-1, keepdims=True)] = 0
        out[:, s] += np.fft.irfft(spec, nfft, axis=-1) * w
        norm[s] += w * w
    norm = np.where(norm > 1e-12, norm, 1.0)
    return (out / norm)[:, pad:pad + n]


def _numpy_probe(x: np.ndarray, f: dict) -> np.ndarray:
    n = x.shape[-1]
    m = np.arange(n)
    tones = sum(a * np.cos(2 * np.pi * k * m / f["nfft"] + ph)
                for k, a, ph in zip(f["probe_bins"], f["probe_amplitudes"],
                                    f["probe_phases"]))
    edge = np.minimum(m, n - 1 - m)
    env = np.where(edge < f["probe_fade"],
                   np.sin(np.pi / 2 * edge / f["probe_fade"]) ** 2, 1.0)
    gain = 2.0 ** np.clip(x[:, :1], -2, 2)
    return gain * env * (tones + f["probe_noise"] * x)


@pytest.mark.parametrize("seed", [4, 2**31 + 9])
def test_reference_matches_numpy(seed):
    x = _noise(2, 8192, seed)
    p = ref.probe(SMALL, x)
    np.testing.assert_allclose(p.numpy(), _numpy_probe(x.double().numpy(),
                                                       SMALL),
                               rtol=0, atol=1e-6)
    got = ref.call(SMALL, x).numpy()
    want = _numpy_gate(p.double().numpy(), SMALL)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
    # the gate removes the noise floor: the answer is not the probe
    assert np.abs(want - p.double().numpy()).max() > 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("seed", [11, 2**31 + 13])
def test_gate_margin_at_the_cell_length(seed):
    """Every bin of the interior frames clears the threshold 10x on its
    side, of the 8 frames at each end of the row 1.1x; at 1024/256 the last
    frame of the padded row lies wholly in the pad."""
    m = ref.gate_margin(FIELDS, _noise(2, N, seed))
    nf = m.shape[-1]
    assert nf == 1876
    assert torch.isinf(m[:, -1]).all()
    assert float(m[:, 8:nf - 9].min()) >= 10.0
    assert float(m[:, :8].min()) >= 1.1
    assert float(m[:, nf - 9:nf - 1].min()) >= 1.1


def test_prepare_is_the_probe_bit_for_bit():
    cell = Cell("gate.batch64")
    x = _noise(3, 20000, 17)
    got = cell.entries().prepare(cell.fields, x)
    want = ref.probe(cell.fields, x)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    # row blocks, as the check computes the reference, give the same bits
    assert torch.equal(ref.probe(cell.fields, x[1:2]), want[1:2])


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import h100bench.reference.spectral_gate_1024_256; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"vv_dsp_tpu_torch", "vv_dsp_tpu", "jax", "jaxlib",
                       "flax"}


@pytest.mark.parametrize("fault", ["no_gate", "rows_swapped"])
def test_planted_faults_fail_the_limit(fault):
    """At the cell's own length: the threshold at 0 lets the probe's noise
    floor through; swapped rows differ by their gains."""
    x = _noise(2, N, 19)
    p = ref.probe(FIELDS, x)
    gate = SpectralGate(threshold=0.0 if fault == "no_gate" else 0.1,
                        device="cpu")
    got = gate(p)
    if fault == "rows_swapped":
        got = got.flip(0)
    assert _err(got, ref.call(FIELDS, x)) > 5 * LIMIT


def test_control_is_coarse():
    x = _noise(2, 8192, 23)
    err = _err(ref.control_call(SMALL, x), ref.call(SMALL, x))
    assert 5 * LIMIT < err < 5e-2
