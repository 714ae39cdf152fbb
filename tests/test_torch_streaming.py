"""The port's streams (vv_dsp_tpu_torch/streaming.py), StreamingNorthStar
and the checkpoint format against the JAX package on the CPU, on the same
numpy blocks.

Tolerances, of the JAX output's max |value|:
- each stream against the JAX stream: 1e-5 (FIR, IIR, the resampler,
  STFT analysis and synthesis: float32 on both sides, another summation
  order or FFT library);
- each stream against the offline op, as tests/test_streaming.py: 2e-5
  FIR, 2e-4 IIR and the resampler;
- StreamingNorthStar at tests/test_models.py's small configuration
  against the JAX chain: 1e-4 of max|MFCC|, flush included; against the
  port's offline composition (tests/test_streaming.py's construction):
  2e-3 absolute;
- scan_stream against the loop, and a resumed stream against the
  unbroken one: equal (one intra-op thread, tests/torch_one_thread.py);
- checkpoints across the packages: leaves equal, continuations within
  the chain's 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vv_dsp_tpu import streaming as jst
from vv_dsp_tpu.models import StreamingNorthStar as JChain
from vv_dsp_tpu.utils import checkpoint as jck
from vv_dsp_tpu_torch import convert
from vv_dsp_tpu_torch import streaming as tst
from vv_dsp_tpu_torch.models import StreamingNorthStar as TChain
from vv_dsp_tpu_torch.ops import fir as tfir
from vv_dsp_tpu_torch.ops import iir as tiir
from vv_dsp_tpu_torch.ops import mel as tmel
from vv_dsp_tpu_torch.ops import resample as trs
from vv_dsp_tpu_torch.ops.stft import STFT
from vv_dsp_tpu_torch.ops.window import get_window_np
from vv_dsp_tpu_torch.utils import checkpoint as tck
from torch_one_thread import one_thread

SMALL = dict(fir_taps=64, up=4, down=3, nfft=256, hop=64, n_mels=32,
             n_mfcc=13)
BLOCK = 768          # 768 in -> 1024 resampled -> 16 frames a block


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture
def sig(rng):
    return rng.standard_normal((3, 4096)).astype(np.float32)


def _run(step, state, x, size, to):
    """Feed x's blocks of `size` through step; the outputs and the end
    state. `to` makes a block of the package's array type."""
    outs = []
    for i in range(0, x.shape[-1], size):
        out, state = step(state, to(x[..., i:i + size]))
        outs.append(_np(out))
    return outs, state


# ---- the streams ----

@pytest.mark.parametrize("taps,block", [(1, 256), (31, 64), (400, 1024),
                                        (400, 256)])
def test_fir_stream_matches_jax(sig, taps, block):
    h = (tfir.design_lowpass_np(taps, 0.3).astype(np.float32) if taps > 1
         else np.array([0.7], np.float32))
    got, gs = _run(lambda s, b: tst.fir_stream_process(h, s, b),
                   tst.fir_stream_init(h, (3,), device="cpu"), sig, block,
                   torch.as_tensor)
    want, ws = _run(lambda s, b: jst.fir_stream_process(h, s, b),
                    jst.fir_stream_init(h, (3,)), sig, block, jnp.asarray)
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5
    if taps > 1:
        assert _rel(gs, ws) == 0
    offline = tfir.fir_apply(h, torch.as_tensor(sig))
    assert _rel(np.concatenate(got, -1), offline) < 2e-5


@pytest.mark.parametrize("block", [128, 512])
def test_iir_stream_matches_jax(sig, block):
    sos = tiir.butter_sos(6, 0.15)
    got, gs = _run(lambda s, b: tst.iir_stream_process(sos, s, b),
                   tst.iir_stream_init(sos, (3,), device="cpu"), sig, block,
                   torch.as_tensor)
    want, ws = _run(lambda s, b: jst.iir_stream_process(sos, s, b),
                    jst.iir_stream_init(sos, (3,)), sig, block, jnp.asarray)
    assert gs.shape == (3, 3, 2)
    assert _rel(np.concatenate(got, -1), np.concatenate(want, -1)) < 1e-5
    assert _rel(gs, ws) < 1e-5
    offline = tiir.iir_apply(sos, torch.as_tensor(sig))
    assert _rel(np.concatenate(got, -1), offline) < 2e-4


@pytest.mark.parametrize("nfft,hop", [(512, 128), (256, 256), (500, 128)])
def test_stft_stream_matches_jax(sig, nfft, hop):
    """Analysis and synthesis block by block, at hop | nfft, at
    nfft == hop (an empty carried tail) and at hop not dividing nfft (the
    gathered frames and the dense overlap-add). The syntheses are compared
    times their w^2 norm: where a frame's edge alone covers a sample, 1/w^2
    amplifies float32 rounding without bound."""
    tss, jss = tst.StftStream(nfft, hop), jst.StftStream(nfft, hop)
    x = sig[..., :hop * (4096 // hop)]
    w2 = get_window_np("hann", nfft) ** 2
    n_frames = x.shape[-1] // hop
    norm = np.zeros((n_frames - 1) * hop + nfft)
    for f in range(n_frames):
        norm[f * hop:f * hop + nfft] += w2
    for rfft in (True, False):
        ta, ts_ = tss.analysis_init((3,), device="cpu"), tss.synthesis_init(
            (3,), device="cpu")
        ja, js_ = jss.analysis_init((3,)), jss.synthesis_init((3,))
        for i in range(0, x.shape[-1], 4 * hop):
            blk = x[..., i:i + 4 * hop]
            spec, ta = tss.analysis(ta, torch.as_tensor(blk), rfft)
            jspec, ja = jss.analysis(ja, jnp.asarray(blk), rfft)
            assert _rel(spec, jspec) < 1e-5
            assert ta.shape[-1] == nfft - hop
            y, ts_ = tss.synthesis(ts_, spec, rfft)
            jy, js_ = jss.synthesis(js_, jspec, rfft)
            nb = norm[i:i + 4 * hop]
            assert _rel(_np(y) * nb, np.asarray(jy) * nb) < 1e-5
        assert ts_[0].shape == (3, nfft - hop)
        if nfft > hop:
            assert _rel(ts_[0], js_[0]) < 1e-5
            assert _rel(ts_[1], js_[1]) < 1e-5


def test_stft_stream_leaves_the_callers_state(sig):
    """Synthesis adds the carried tail on a fresh tensor, never in place."""
    s = tst.StftStream(512, 128)
    spec, _ = s.analysis(s.analysis_init((3,), device="cpu"),
                         torch.as_tensor(sig[:, :512]))
    acc = torch.ones(3, 384)
    state = (acc, acc.clone())
    s.synthesis(state, spec)
    assert torch.equal(acc, torch.ones(3, 384))


@pytest.mark.parametrize("up,down,block", [(2, 1, 300), (4, 3, 384),
                                           (3, 4, 512), (160, 147, 1470)])
def test_resample_stream_matches_jax(sig, up, down, block):
    trs_, jrs_ = tst.ResamplePolyStream(up, down), jst.ResamplePolyStream(
        up, down)
    assert trs_.latency_out == jrs_.latency_out
    x = sig[..., :(4096 // block) * block]
    got, gs = _run(trs_.process, trs_.init((3,), device="cpu"), x, block,
                   torch.as_tensor)
    want, ws = _run(jrs_.process, jrs_.init((3,)), x, block, jnp.asarray)
    got.append(_np(trs_.flush(gs)))
    want.append(np.asarray(jrs_.flush(ws)))
    got, want = np.concatenate(got, -1), np.concatenate(want, -1)
    assert _rel(got, want) < 1e-5
    offline = trs.resample_poly(torch.as_tensor(x), up, down)
    lat = trs_.latency_out
    assert _rel(got[..., lat:lat + offline.shape[-1]], offline) < 2e-4


# ---- scan_stream ----

def test_scan_stream_equals_the_loop(sig):
    h = tfir.design_lowpass_np(101, 0.3)
    step = lambda s, b: tst.fir_stream_process(h, s, b)
    s0 = tst.fir_stream_init(h, (3,), device="cpu")
    x = torch.as_tensor(sig)
    with one_thread():
        outs, state = _run(step, s0, sig, 512, torch.as_tensor)
        got, end = tst.scan_stream(step, s0, x, 512)
    assert torch.equal(got, torch.as_tensor(np.concatenate(outs, -1)))
    assert torch.equal(end, state)
    st = tst.StftStream(256, 64)
    a0 = st.analysis_init((3,), device="cpu")
    with one_thread():
        outs, state = _run(st.analysis, a0, sig, 256, torch.as_tensor)
        got, end = tst.scan_stream(st.analysis, a0, x, 256, out_axis=-2)
        got1, _ = tst.scan_stream(st.analysis, a0, x, 256, out_axis=1)
    assert torch.equal(got, torch.as_tensor(np.concatenate(outs, -2)))
    assert torch.equal(got1, got) and torch.equal(end, state)
    jgot, _ = jst.scan_stream(
        jst.StftStream(256, 64).analysis,
        jst.StftStream(256, 64).analysis_init((3,)), jnp.asarray(sig), 256,
        out_axis=-2)
    assert got.shape == jgot.shape


def test_scan_stream_validates(sig):
    x = torch.as_tensor(sig)
    with pytest.raises(ValueError):
        tst.scan_stream(lambda s, b: (b, s), torch.zeros(3, 4), x, 1000)
    with pytest.raises(TypeError):
        tst.scan_stream(lambda s, b: ((b, b), s), None, x, 1024)
    with pytest.raises(ValueError):
        tst.scan_stream(lambda s, b: (b, s), None, x, 1024, out_axis=-3)
    # no block: JAX's lax.scan gives empty outputs; the port cannot know
    # the output's shape without a step, and refuses (ROADMAP Queue 3)
    with pytest.raises(ValueError, match="at least one block"):
        tst.scan_stream(lambda s, b: (b, s), None, x[:, :0], 1024)


# ---- StreamingNorthStar ----

def _chain_run(chain, state, x, to, n_blocks=8):
    feats = []
    for i in range(n_blocks):
        f, state = chain.process(state, to(x[..., i * BLOCK:(i + 1) * BLOCK]))
        feats.append(_np(f))
    return np.concatenate(feats, -2), state


def test_streaming_chain_matches_jax(rng):
    x = rng.standard_normal((2, 8 * BLOCK)).astype(np.float32)
    tc, jc = TChain(**SMALL), JChain(**SMALL)
    assert tc.validate_block(BLOCK) == jc.validate_block(BLOCK) == 16
    got, gs = _chain_run(tc, tc.init((2,), device="cpu"), x,
                         torch.as_tensor)
    want, ws = _chain_run(jc, jc.init((2,)), x, jnp.asarray)
    assert got.shape == want.shape == (2, 128, 13)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-4 * scale
    tail, jtail = _np(tc.flush(gs)), np.asarray(jc.flush(ws))
    assert tail.shape == jtail.shape
    assert np.abs(tail - jtail).max() < 1e-4 * scale
    for key in ("fir", "resample", "stft"):
        assert _rel(gs[key], ws[key]) < 1e-5
    np.testing.assert_array_equal(tc.fir_coeffs, np.asarray(jc.fir_coeffs))


def test_streaming_chain_matches_the_offline_composition(rng):
    """tests/test_streaming.py's construction on the port's ops:
    fir_apply -> resample_poly of the zero-led signal -> STFT power ->
    mfcc; streamed frame f is offline frame f - (nfft/hop - 1). With
    flush, every offline frame is streamed."""
    x = rng.standard_normal((2, 8 * BLOCK)).astype(np.float32)
    tc = TChain(**SMALL)
    got, state = _chain_run(tc, tc.init((2,), device="cpu"), x,
                            torch.as_tensor)
    got = np.concatenate([got, _np(tc.flush(state))], -2)
    delay_in = tc._resampler._geometry[3]
    y = tfir.fir_apply(tc.fir_coeffs, torch.as_tensor(x))
    y2 = trs.resample_poly(torch.nn.functional.pad(y, (delay_in, 0)), 4, 3)
    offline = tmel.mfcc(STFT(256, 64).power(y2), 256, 32, 13,
                        48000.0 * 4 / 3).numpy()
    warm = 256 // 64 - 1
    assert got.shape[-2] - warm == offline.shape[-2]
    assert np.abs(got[..., warm:, :] - offline).max() < 2e-3


def test_process_blocks_equals_process(rng):
    x = torch.as_tensor(rng.standard_normal((2, 4 * BLOCK)),
                        dtype=torch.float32)
    tc = TChain(**SMALL)
    s0 = tc.init((2,), device="cpu")
    with one_thread():
        want, ws = _chain_run(tc, s0, x, lambda b: b, 4)
        got, gs = tc.process_blocks(s0, x, BLOCK)
    assert torch.equal(got, torch.as_tensor(want))
    assert all(torch.equal(gs[k], ws[k]) for k in ws)
    with pytest.raises(ValueError):
        tc.process_blocks(s0, x, 700)


def test_checkpoint_resume_is_exact(rng, tmp_path):
    x = torch.as_tensor(rng.standard_normal((2, 6 * BLOCK)),
                        dtype=torch.float32)
    tc = TChain(**SMALL)
    path = str(tmp_path / "mid.npz")
    with one_thread():
        _, mid = _chain_run(tc, tc.init((2,), device="cpu"), x,
                            lambda b: b, 3)
        tck.save(path, mid)
        restored = tck.load(path, tc.init((2,), device="cpu"))
        assert list(restored) == list(mid)
        a, _ = _chain_run(tc, mid, x[..., 3 * BLOCK:], lambda b: b, 3)
        b, _ = _chain_run(tc, restored, x[..., 3 * BLOCK:], lambda b: b, 3)
    np.testing.assert_array_equal(a, b)


def test_checkpoints_load_across_the_packages(rng, tmp_path):
    """A JAX-written checkpoint resumes in the port, a port-written one in
    JAX: the leaves arrive equal, and each continuation matches the other
    package's."""
    x = rng.standard_normal((2, 6 * BLOCK)).astype(np.float32)
    tc, jc = TChain(**SMALL), JChain(**SMALL)
    _, jmid = _chain_run(jc, jc.init((2,)), x, jnp.asarray, 3)
    _, tmid = _chain_run(tc, tc.init((2,), device="cpu"), x,
                         torch.as_tensor, 3)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save(jpath, jmid)
    tck.save(tpath, tmid)
    in_port = tck.load(jpath, tc.init((2,), device="cpu"))
    in_jax = jck.load(tpath, jc.init((2,)))
    for key in ("fir", "resample", "stft"):
        np.testing.assert_array_equal(in_port[key].numpy(),
                                      np.asarray(jmid[key]))
        np.testing.assert_array_equal(np.asarray(in_jax[key]),
                                      tmid[key].numpy())
    rest = x[..., 3 * BLOCK:]
    a, _ = _chain_run(tc, in_port, rest, torch.as_tensor, 3)
    b, _ = _chain_run(jc, jmid, rest, jnp.asarray, 3)
    c, _ = _chain_run(jc, in_jax, rest, jnp.asarray, 3)
    d, _ = _chain_run(tc, tmid, rest, torch.as_tensor, 3)
    scale = np.abs(b).max()
    assert np.abs(a - b).max() < 1e-4 * scale
    assert np.abs(c - d).max() < 1e-4 * scale
    # the paths of a nested tree, spelled as JAX spells them
    tree = {"b": (np.zeros(2, np.float32), [np.ones(3, np.float32)]),
            "a": np.arange(4)}
    tck.save(tpath, tree)
    with np.load(tpath) as data:
        assert list(data["__paths__"]) == [
            jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    back = jck.load(tpath, tree)
    np.testing.assert_array_equal(np.asarray(back["b"][1][0]), tree["b"][1][0])


def test_checkpoint_load_validates(tmp_path):
    tc = TChain(**SMALL)
    state = tc.init((2,), device="cpu")
    path = str(tmp_path / "s.npz")
    tck.save(path, state)
    with pytest.raises(ValueError, match="shape"):
        tck.load(path, tc.init((3,), device="cpu"))
    with pytest.raises(ValueError, match="dtype"):
        tck.load(path, tc.init((2,), torch.float64, device="cpu"))
    with pytest.raises(ValueError, match="structure"):
        tck.load(path, {"fir": state["fir"], "resample": state["resample"],
                        "tail": state["stft"]})
    with pytest.raises(ValueError, match="leaves"):
        tck.load(path, {"fir": state["fir"]})
    single = str(tmp_path / "one.npz")
    tck.save(single, torch.arange(3.0))
    with np.load(single) as data:
        assert list(data["__paths__"]) == [""]
    assert torch.equal(tck.load(single, torch.zeros(3)), torch.arange(3.0))


def test_stream_state_from_reference_resumes_a_jax_stream(rng):
    x = rng.standard_normal((2, 6 * BLOCK)).astype(np.float32)
    tc, jc = TChain(**SMALL), JChain(**SMALL)
    _, jmid = _chain_run(jc, jc.init((2,)), x, jnp.asarray, 3)
    state = convert.stream_state_from_reference(
        jax.tree_util.tree_map(np.asarray, jmid), device="cpu")
    assert set(state) == {"fir", "resample", "stft"}
    assert all(isinstance(v, torch.Tensor) for v in state.values())
    rest = x[..., 3 * BLOCK:]
    a, _ = _chain_run(tc, state, rest, torch.as_tensor, 3)
    b, _ = _chain_run(jc, jmid, rest, jnp.asarray, 3)
    assert np.abs(a - b).max() < 1e-4 * np.abs(b).max()
    pair = convert.stream_state_from_reference(
        (np.zeros(2, np.float32), [np.ones(2)]), device="cpu")
    assert isinstance(pair, tuple) and pair[1][0].dtype == torch.float64


def test_streaming_params_from_reference():
    jc = JChain()
    params = convert.streaming_params_from_reference(np.asarray(
        jc.fir_coeffs))
    tc = TChain(params=params)
    np.testing.assert_array_equal(tc.fir_coeffs, TChain().fir_coeffs)
    assert tc == TChain()
    with pytest.raises(ValueError):
        convert.streaming_params_from_reference(np.zeros((2, 2)))


def test_every_init_raises_without_a_card(monkeypatch):
    """State is built on the card by default, and never on the CPU in its
    place: without a GPU every init raises unless the CPU is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sos = tiir.butter_sos(2, 0.2)
    inits = (lambda **k: TChain().init((16,), **k),
             lambda **k: tst.fir_stream_init(np.ones(8), (2,), **k),
             lambda **k: tst.iir_stream_init(sos, (2,), **k),
             lambda **k: tst.StftStream(256, 64).analysis_init((2,), **k),
             lambda **k: tst.StftStream(256, 64).synthesis_init((2,), **k),
             lambda **k: tst.ResamplePolyStream(4, 3).init((2,), **k),
             lambda **k: convert.stream_state_from_reference(
                 {"a": np.zeros(2)}, **k))
    for init in inits:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init()
        init(device="cpu")
    assert TChain().init((16,), device="cpu")["fir"].shape == (16, 1023)
