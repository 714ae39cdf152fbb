"""The port's north-star slice against the JAX package and float64 oracles,
on the CPU (the kernels' plain versions).

Tolerances, as fractions of max |value|:
- port chain vs JAX chain: 5e-5 at the default tiers (the port's CPU path
  keeps the bf16x3 tiers, the JAX CPU path computes in float32, so the
  two differ by the tier's error; measured 1.4e-5) and 1e-5 at f32
  (summation order only; measured 2.8e-6);
- chain vs float64 oracle: 5e-5 default, 1e-5 f32, as
  tests/test_models.py::test_northstar_chain_f64_oracle_parity;
- STFT.process vs JAX: 5e-5, the FFT-class parity contract.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vv_dsp_tpu.models import NorthStarChain as JaxChain
from vv_dsp_tpu.ops import pallas_kernels as jpk
from vv_dsp_tpu.ops.stft import STFT as JaxSTFT
from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.models import NorthStarChain
from vv_dsp_tpu_torch.ops import mel as tmel
from vv_dsp_tpu_torch.ops import resample as trs
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops import upfirdn as tuf
from vv_dsp_tpu_torch.ops.stft import STFT
from vv_dsp_tpu_torch.utils.kernel_grad import kernel_with_torch_vjp

REPO = pathlib.Path(__file__).resolve().parents[1]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    dt = np.complex128 if np.iscomplexobj(want) else np.float64
    want = want.astype(dt)
    return np.abs(got.astype(dt) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("algorithm,tol", [("bf16x3", 5e-5), ("f32", 1e-5)])
def test_chain_matches_jax_chain(rng, algorithm, tol):
    x = rng.standard_normal((2, 24000)).astype(np.float32)
    want = JaxChain(head_algorithm=algorithm,
                    stft_algorithm=algorithm)(jnp.asarray(x))
    got = NorthStarChain(head_algorithm=algorithm, stft_algorithm=algorithm,
                         device="cpu")(torch.as_tensor(x))
    assert got.shape == want.shape == (2, 60, 20)
    assert got.dtype == torch.float32
    assert _rel(got, want) < tol


def _chain_oracle(x64, chain):
    """tests/test_models.py's float64 scipy/numpy oracle of the chain."""
    from scipy import signal as ss
    from vv_dsp_tpu.ops.dct import _dct2_matrix
    from vv_dsp_tpu.ops.mel import mel_filterbank_np
    from vv_dsp_tpu.ops.window import get_window_np

    h = chain.fir_coeffs.astype(np.float64)
    y = ss.lfilter(h, [1.0], x64, axis=-1)
    yr = ss.resample_poly(y, chain.up, chain.down, axis=-1)
    n_out = -(-y.shape[-1] * chain.up // chain.down)
    yr = yr[..., :n_out]
    nfft, hop = chain.nfft, chain.hop
    w = get_window_np("hann", nfft, None)
    nf = 1 + (n_out - nfft + hop) // hop
    frames = np.stack(
        [np.pad(yr[:, i * hop:i * hop + nfft],
                ((0, 0), (0, max(0, nfft - (n_out - i * hop)))))
         for i in range(nf)], axis=1)
    pw = np.abs(np.fft.rfft(frames * w, axis=-1)) ** 2
    sr = chain.sample_rate * chain.up / chain.down
    fb = mel_filterbank_np(nfft, chain.n_mels, sr, 0.0, sr / 2, "htk")
    lm = np.log(pw @ fb.T + 1e-10)
    return lm @ _dct2_matrix(chain.n_mels)[:chain.n_mfcc].T


@pytest.mark.parametrize("algorithm,tol", [("bf16x3", 5e-5), ("f32", 1e-5)])
def test_chain_f64_oracle_parity(rng, algorithm, tol):
    x64 = rng.standard_normal((2, 48000))
    chain = NorthStarChain(head_algorithm=algorithm, stft_algorithm=algorithm,
                           device="cpu")
    got = chain(torch.as_tensor(x64, dtype=torch.float32))
    want = _chain_oracle(x64, chain)
    assert got.shape == want.shape
    assert _rel(got, want) < tol


@pytest.mark.parametrize("rfft", [False, True])
def test_stft_process_matches_jax(rng, rfft):
    x = rng.standard_normal((2, 48000)).astype(np.float32)
    want = JaxSTFT(1024, 256).process(jnp.asarray(x), rfft=rfft)
    got = STFT(1024, 256).process(torch.as_tensor(x), rfft=rfft)
    assert got.shape == want.shape == (2, 185, 513 if rfft else 1024)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) < 5e-5


def test_stft_process_rank_and_complex(rng):
    x = rng.standard_normal((3, 2, 5000)).astype(np.float32)
    got = STFT(1024, 256).process(torch.as_tensor(x))
    flat = STFT(1024, 256).process(torch.as_tensor(x.reshape(6, 5000)))
    torch.testing.assert_close(got.reshape(flat.shape), flat, rtol=0, atol=0)
    z = (x[0] + 1j * x[1]).astype(np.complex64)
    want = JaxSTFT(1024, 256).process(jnp.asarray(z))
    assert _rel(STFT(1024, 256).process(torch.as_tensor(z)).numpy(),
                want) < 5e-5


def test_kernel_with_torch_vjp_gradient_is_the_plain_one(rng):
    """Forward is the fast callable's, backward the reference's VJP: here
    fast = the bf16x3 head, ref = the f32 head."""
    h = NorthStarChain(device="cpu").fir_coeffs.astype(np.float64)
    g, off = trs._fused_fir_resample_filter(tuple(h), 4, 3)
    taps = tuf.polyphase_table(g, 4, "cpu")
    fast = lambda v: tuf.upfirdn_banded(v, taps, 4, 3, off, 4000, "bf16x3")
    ref = lambda v: tuf.upfirdn_tall(v, taps, 4, 3, off, 4000, "f32")
    f = kernel_with_torch_vjp(fast, ref)
    x = torch.as_tensor(rng.standard_normal((2, 3000)), dtype=torch.float32)
    cot = torch.as_tensor(rng.standard_normal((2, 4000)), dtype=torch.float32)
    xa = x.clone().requires_grad_(True)
    ya = f(xa)
    torch.testing.assert_close(ya.detach(), fast(x), rtol=0, atol=0)
    (ga,) = torch.autograd.grad(ya, xa, cot)
    xb = x.clone().requires_grad_(True)
    (gb,) = torch.autograd.grad(ref(xb), xb, cot)
    torch.testing.assert_close(ga, gb, rtol=0, atol=0)


def test_kernel_with_torch_vjp_multiple_inputs(rng):
    f = kernel_with_torch_vjp(lambda a, b: a * b + 1.0, lambda a, b: a * b)
    a = torch.as_tensor(rng.standard_normal(5)).requires_grad_(True)
    b = torch.as_tensor(rng.standard_normal(5))
    (ga,) = torch.autograd.grad(f(a, b).sum(), a)
    torch.testing.assert_close(ga, b)


def test_chain_gradient_matches_jax(rng):
    """The chain differentiates through each kernel's plain f32 version,
    as the JAX chain does through its XLA path."""
    x = rng.standard_normal((1, 12000)).astype(np.float32)
    ref = JaxChain(head_algorithm="f32", stft_algorithm="f32")
    want = jax.grad(lambda v: jnp.sum(ref(v)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    NorthStarChain(head_algorithm="f32", stft_algorithm="f32",
                   device="cpu")(xt).sum().backward()
    assert torch.isfinite(xt.grad).all()
    assert _rel(xt.grad, want) < 1e-4


def test_mfcc_from_log_mel_matches_jax(rng):
    from vv_dsp_tpu.ops.mel import mfcc_from_log_mel
    lm = rng.standard_normal((2, 7, 26)).astype(np.float32)
    want = mfcc_from_log_mel(jnp.asarray(lm), 13, 22.0)
    got = tmel.mfcc_from_log_mel(torch.as_tensor(lm), 13, 22.0)
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("algorithm", ["f32", "bf16x3", "bf16"])
def test_tier_matmul_matches_jax_dot_alg(rng, algorithm):
    w = rng.standard_normal((24, 300)).astype(np.float32)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    want = jpk.dot_alg(jnp.asarray(w), jnp.asarray(x), algorithm)
    got = config.tier_matmul(torch.as_tensor(w), torch.as_tensor(x),
                             algorithm)
    assert _rel(got, want) < 1e-6


def test_precision_and_dtype_policy():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert config.dot_algorithm(None) == "f32"
    with pytest.raises(ValueError):
        config.dot_algorithm("tf32")
    assert config.as_compute(torch.zeros(3, dtype=torch.int16)).dtype == \
        torch.float32
    assert config.as_compute(torch.zeros(3, dtype=torch.bfloat16)).dtype == \
        torch.float32
    assert config.as_compute(torch.zeros(3, dtype=torch.float64)).dtype == \
        torch.float64
    z = torch.zeros(3, dtype=torch.complex64)
    assert config.as_compute(z) is z


def test_unported_chain_options_raise():
    with pytest.raises(NotImplementedError):
        NorthStarChain(fused_head=False, device="cpu")


def test_chain_module_moves_its_buffers():
    chain = NorthStarChain(device="cpu").to(torch.float32)
    assert chain.head_taps.shape == (4, 1044)
    assert chain.window.shape == (2048,)
    assert chain.mel_fb.shape == (80, 1025)
    assert chain.dct_lift.shape == (20, 80)
    assert all(b.device.type == "cpu" for b in chain.buffers())


def test_chain_builds_on_the_card_by_default(monkeypatch):
    """The default device is the card: without one the chain raises
    instead of building on the CPU, and an input on another device than
    the buffers is refused, not moved."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NorthStarChain()
    chain = NorthStarChain(device="cpu")
    with pytest.raises(ValueError, match="buffers on cpu"):
        chain(torch.zeros(1, 4000, device="meta"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    """No file of the port, nor chip_smoke.py, imports jax or the JAX
    package. An AST scan rather than an import check: a site customization
    may import jax into every process, so a fresh import could not tell."""
    files = sorted((REPO / "vv_dsp_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 24
    assert {"istft_kernels.py", "packed.py"} <= {p.name for p in files}
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "vv_dsp_tpu"), (path, mod)


def test_counters_start_as_plain_integers():
    from vv_dsp_tpu_torch.ops import istft_kernels as tik
    for fn in (tuf.upfirdn_banded, tsk.stft_mfcc, tsk.stft_spectrum,
               tsk.stft_power, tik.istft):
        assert isinstance(fn.launches, int)
