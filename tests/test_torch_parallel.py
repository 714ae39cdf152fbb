"""The port's sharded path (vv_dsp_tpu_torch.parallel, NorthStarChain and
SpectralGate.apply_sharded) against the JAX package's dense functions on
the same seeded numpy input, on meshes of 8 CPU devices, at the JAX
suite's own tolerances (tests/test_parallel.py): FIR 2e-5, IIR 1e-4, STFT
1e-4, the roundtrip's interior 5e-4, resampling and savgol 2e-4, filtfilt
5e-4, the global FFT 2e-4 relative and 2e-3 absolute, Hilbert and
cepstrum 1e-3, the flagship chain 2e-3 of scale and its fused halos
against its staged path 2e-4 of scale.

The JAX suite already holds the JAX sharded functions to the JAX dense
ones; a JAX sharded function, which compiles a shard_map program on 8
devices, is called here in two cases only: the flagship chain and a halo
wider than a block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from vv_dsp_tpu.models import NorthStarChain as JChain
from vv_dsp_tpu.models import SpectralGate as JGate
from vv_dsp_tpu.ops import envelope as jenv
from vv_dsp_tpu.ops import fft as jfft
from vv_dsp_tpu.ops import fir as jfir
from vv_dsp_tpu.ops import hilbert as jhil
from vv_dsp_tpu.ops import iir as jiir
from vv_dsp_tpu.ops import resample as jrs
from vv_dsp_tpu.ops import savgol as jsg
from vv_dsp_tpu.ops.stft import STFT as JSTFT
from vv_dsp_tpu.parallel import mesh as jmesh
from vv_dsp_tpu.parallel import ops as jpops

from vv_dsp_tpu_torch import parallel as tp
from vv_dsp_tpu_torch.models import NorthStarChain, SpectralGate
from vv_dsp_tpu_torch.ops import stockham_kernels as tstk
from vv_dsp_tpu_torch.ops.stft import STFT
from vv_dsp_tpu_torch.ops.window import get_window_np
from vv_dsp_tpu_torch.parallel import halo as thalo
from vv_dsp_tpu_torch.parallel.mesh import TORCHRUN_ENV

MESH_SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]
CPU8 = [torch.device("cpu")] * 8
N_CHAIN = 8 * 2048 * 3     # divides every block, hop and ratio constraint


def mesh_of(shape):
    return tp.make_mesh(*shape, devices=CPU8)


@functools.lru_cache(maxsize=1)
def _sig() -> np.ndarray:
    return np.random.default_rng(1234).standard_normal(
        (8, 4096)).astype(np.float32)


@pytest.fixture
def sig():
    return _sig()


def _np(t):
    return t.gather().numpy() if isinstance(t, tp.ShardedTensor) else \
        np.asarray(t)


def close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---- the JAX dense references, each computed once ----

@functools.lru_cache(maxsize=None)
def jax_fir(taps: int) -> np.ndarray:
    h = jfir.design_lowpass(taps, 0.25) if taps > 1 else jnp.ones((1,))
    return np.asarray(jfir.fir_apply(h, jnp.asarray(_sig())))


@functools.lru_cache(maxsize=None)
def jax_stft(nfft: int, hop: int, n: int = 4096) -> np.ndarray:
    return np.asarray(JSTFT(nfft, hop).process(jnp.asarray(_sig()[:, :n]),
                                               rfft=True))


@functools.lru_cache(maxsize=None)
def jax_resample(up: int, down: int, n: int) -> np.ndarray:
    return np.asarray(jrs.resample_poly(jnp.asarray(_sig()[:, :n]), up,
                                        down))


@functools.lru_cache(maxsize=None)
def jax_iir(sos_bytes: bytes) -> np.ndarray:
    sos = np.frombuffer(sos_bytes).reshape(-1, 6)
    return np.asarray(jax.jit(lambda v: jiir.iir_apply(sos, v))(
        jnp.asarray(_sig())))


@functools.lru_cache(maxsize=None)
def jax_chain() -> tuple:
    x = np.random.default_rng(1234).standard_normal(
        (2, N_CHAIN)).astype(np.float32)
    return x, np.asarray(JChain()(jnp.asarray(x)))


# ---- mesh, sharded tensors, halos ----

def test_make_mesh_raises_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.make_mesh()
    mesh = tp.make_mesh(2, devices=CPU8)
    assert mesh.shape == {"channel": 2, "block": 4}
    assert mesh.shape == dict(jmesh.make_mesh(2, 4).shape)
    with pytest.raises(ValueError, match="mesh 3x4 != 8 devices"):
        tp.make_mesh(3, 4, devices=CPU8)
    assert tp.make_mesh(devices=CPU8).shape == {"channel": 1, "block": 8}
    # without arguments or torchrun's environment: a no-op
    for var in TORCHRUN_ENV:
        monkeypatch.delenv(var, raising=False)
    tp.initialize_distributed()
    assert not dist.is_initialized()
    assert (tp.process_index(), tp.process_count()) == (0, 1)
    # one rank: a group whose mesh equals the single-process one
    tp.initialize_distributed(f"file://{tmp_path}/rdv", 1, 0, timeout=30)
    try:
        assert (tp.process_index(), tp.process_count()) == (0, 1)
        grouped = tp.make_mesh(2, devices=CPU8)
        assert grouped.devices == mesh.devices
        assert grouped.owners == mesh.owners == ((0,) * 4,) * 2
        tp.initialize_distributed(f"file://{tmp_path}/rdv", 1, 0)
        with pytest.raises(RuntimeError, match="already initialized"):
            tp.initialize_distributed(f"file://{tmp_path}/rdv", 2, 1)
    finally:
        dist.destroy_process_group()


def test_pad_to_blocks_and_block_size():
    mesh = mesh_of((1, 8))
    xp, n = tp.pad_to_blocks(torch.ones(2, 100), mesh)
    assert xp.shape[-1] == 104 and n == 100
    assert (xp[..., 100:] == 0).all()
    assert tp.block_size(mesh, 104) == 13
    with pytest.raises(ValueError):
        tp.block_size(mesh, 100)


def test_sharded_tensor_layout(sig):
    mesh = mesh_of((2, 4))
    xs = tp.shard(torch.as_tensor(sig), mesh)
    assert len(xs.shards) == 2 and len(xs.shards[0]) == 4
    assert xs.shards[1][2].shape == (4, 1024)
    assert xs.shape == (8, 4096)
    assert torch.equal(xs.shards[1][2], torch.as_tensor(sig[4:, 2048:3072]))
    assert torch.equal(xs.gather(), torch.as_tensor(sig))
    assert tp.shard(xs, mesh) is xs
    cropped = xs.crop(100, 3000)
    assert [s.shape[-1] for s in cropped.shards[0]] == [924, 1024, 952, 0]
    assert torch.equal(cropped.gather(), torch.as_tensor(sig[:, 100:3000]))
    with pytest.raises(ValueError, match="not divisible by 8 block"):
        tp.shard(torch.zeros(8, 100), mesh_of((1, 8)))
    per = tp.shard_channels(torch.as_tensor(sig), mesh_of((4, 2)))
    assert [len(r) for r in per.shards] == [1] * 4
    assert torch.equal(per.map(lambda v: v * 2).gather(),
                       torch.as_tensor(sig) * 2)


@pytest.mark.parametrize("halo", [0, 5, 64, 100, 200])
def test_halos_against_the_signal(halo):
    """Halos read the neighbours' samples, zeros past either end, over as
    many blocks as they span; with one block shard they are all zeros."""
    x = torch.arange(1, 8 * 3 * 64 + 1, dtype=torch.float32).reshape(3, -1)
    blocks = list(x.split(64, dim=-1))
    pad = torch.nn.functional.pad(x, (halo, halo))
    for k, (left, right) in enumerate(zip(thalo.halo_from_left(blocks, halo),
                                          thalo.halo_from_right(blocks,
                                                                halo))):
        assert torch.equal(left, pad[:, k * 64:k * 64 + halo])
        assert torch.equal(right, pad[:, halo + (k + 1) * 64:
                                      2 * halo + (k + 1) * 64])
    if halo:
        assert not thalo.halo_from_left([x], halo)[0].any()
        assert not thalo.halo_from_right([x], halo)[0].any()


@pytest.mark.parametrize("spill", [10, 64, 150])
def test_spill_add_right(spill):
    """Each shard's spill lands on the blocks to its right (several when
    it is longer than a block); the last shard's overflow is dropped."""
    gen = np.random.default_rng(3)
    bufs = [torch.as_tensor(gen.standard_normal((2, 64))) for _ in range(4)]
    spills = [torch.as_tensor(gen.standard_normal((2, spill)))
              for _ in range(4)]
    want = torch.cat(bufs, dim=-1)
    for k, s in enumerate(spills):
        end = min((k + 1) * 64 + spill, 256)
        want[:, (k + 1) * 64:end] += s[:, :end - (k + 1) * 64]
    got = torch.cat(thalo.spill_add_right(bufs, spills), dim=-1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    assert thalo.spill_add_right(bufs[:1], spills[:1])[0] is bufs[0]


# ---- sharded ops against the JAX dense functions ----

@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("taps", [1, 9, 64, 257])
def test_fir_sharded_matches_jax(sig, shape, taps):
    h = (np.asarray(jfir.design_lowpass(taps, 0.25)) if taps > 1
         else np.ones(1))
    close(tp.fir_apply_sharded(h, torch.as_tensor(sig), mesh_of(shape)),
          jax_fir(taps), 2e-5)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_fir_sharded_fft_path(sig, shape):
    h = np.asarray(jfir.design_lowpass(301, 0.1))
    want = jfir.fir_apply(jnp.asarray(h), jnp.asarray(sig))
    close(tp.fir_apply_sharded(h, torch.as_tensor(sig), mesh_of(shape),
                               use_fft=True), want, 5e-5)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_iir_sharded_matches_jax(sig, shape):
    sos = np.asarray(jiir.butter_sos(4, 0.2))
    # jitted: the eager JAX scan dispatches every level's ops (~17 s)
    want = jax_iir(sos.tobytes())
    close(tp.iir_apply_sharded(sos, torch.as_tensor(sig), mesh_of(shape)),
          want, 1e-4)


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("nfft,hop", [(256, 64), (1024, 256), (512, 512)])
def test_stft_sharded_matches_jax(sig, shape, nfft, hop):
    """n // hop frames; the reference count can exceed it by a wholly
    zero-padded frame at nfft == hop, which is zero."""
    want = jax_stft(nfft, hop)
    got = _np(tp.stft_process_sharded(torch.as_tensor(sig), nfft, hop,
                                      mesh_of(shape)))
    assert got.shape[-2] == 4096 // hop
    nf = min(want.shape[-2], got.shape[-2])
    close(got[..., :nf, :], want[..., :nf, :], 1e-4)
    np.testing.assert_allclose(want[..., nf:, :], 0.0, atol=1e-6)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_stft_roundtrip_sharded(sig, shape):
    """The interior reconstructs the signal and equals the JAX dense
    reconstruction of the same spectrum; everywhere, both edges included,
    the sharded roundtrip equals the port's dense reconstruction (the
    seam-stitching contract, held as the JAX suite holds it: against the
    same package's inverse, since near the edges 1/w^2 amplifies the
    rounding of two irfft implementations past the limit)."""
    mesh = mesh_of(shape)
    spec = tp.stft_process_sharded(torch.as_tensor(sig), 512, 128, mesh)
    out = _np(tp.stft_reconstruct_sharded(spec, 512, 128, mesh))
    close(out[..., 512:-512], sig[..., 512:-512], 5e-4)
    dense = JSTFT(512, 128).reconstruct(jnp.asarray(_np(spec)), 4096,
                                        rfft=True)
    close(out[..., 512:-512], np.asarray(dense)[..., 512:-512], 5e-4)
    close(out, STFT(512, 128).reconstruct(spec.gather(), 4096, rfft=True),
          5e-4)


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("up,down", [(2, 1), (1, 2), (4, 3), (3, 4),
                                     (160, 147)])
def test_resample_poly_sharded_matches_jax(sig, shape, up, down):
    nb = shape[1]
    n = 4096 // (nb * down) * nb * down
    got = tp.resample_poly_sharded(torch.as_tensor(sig[:, :n]), up, down,
                                   mesh_of(shape))
    close(got, jax_resample(up, down, n), 2e-4)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_savgol_sharded_matches_jax(sig, shape):
    want = jsg.savgol_filter(jnp.asarray(sig), 21, 3)
    close(tp.savgol_filter_sharded(torch.as_tensor(sig), 21, 3,
                                   mesh_of(shape)), want, 2e-4)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_filtfilt_sharded_matches_jax(sig, shape):
    h = np.asarray(jfir.design_lowpass(33, 0.25))
    want = jfir.filtfilt_fir(jnp.asarray(h), jnp.asarray(sig))
    close(tp.filtfilt_fir_sharded(h, torch.as_tensor(sig), mesh_of(shape)),
          want, 5e-4)


def _cyclic(n: int, nb: int) -> np.ndarray:
    """Global bin of each element of the cyclic layout, in shard order."""
    t = n // nb
    return np.concatenate([k1 + nb * np.arange(t) for k1 in range(nb)])


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_fft_sharded_matches_jax(sig, shape):
    spec = _np(tp.fft_sharded(torch.as_tensor(sig[:, :1024]),
                              mesh_of(shape)))
    want = np.asarray(jfft.fft(jnp.asarray(sig[:, :1024])))
    np.testing.assert_allclose(spec, want[:, _cyclic(1024, shape[1])],
                               rtol=2e-4, atol=2e-3)
    k1 = 1 % shape[1]
    assert torch.equal(tp.fft.cyclic_freq_indices(4, shape[1], k1),
                       torch.as_tensor(k1 + shape[1] * np.arange(4)))


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_fft_sharded_roundtrip(sig, shape):
    mesh = mesh_of(shape)
    back = _np(tp.ifft_sharded(tp.fft_sharded(torch.as_tensor(sig[:, :2048]),
                                              mesh), mesh))
    np.testing.assert_allclose(back.real, sig[:, :2048], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(back.imag, 0.0, atol=1e-4)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_hilbert_sharded_matches_jax(sig, shape):
    want = np.asarray(jhil.hilbert_analytic(jnp.asarray(sig)))
    got = _np(tp.hilbert_analytic_sharded(torch.as_tensor(sig),
                                          mesh_of(shape)))
    close(got.real, want.real, 1e-3)
    close(got.imag, want.imag, 1e-3)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_cepstrum_sharded_matches_jax(sig, shape):
    x = sig[:, :2048] + 2.0
    want = jenv.cepstrum_real(jnp.asarray(x))
    close(tp.cepstrum_real_sharded(torch.as_tensor(x), mesh_of(shape)), want,
          1e-3)


def test_fft_sharded_long_signal():
    """Past 1M samples the twiddles stay accurate (their phase index is
    formed in integers, reduced mod n, and only then scaled in float32):
    the roundtrip holds, the tone's two bins (12345 and n - 12345) hold
    n/2 each and every other bin stays below 1e-3 of n."""
    mesh = mesh_of((1, 8))
    n = 1 << 21
    t = np.arange(n)
    x = np.sin(2 * np.pi * 12345.0 * t / n)[None, :].repeat(2, 0).astype(
        np.float32)
    spec = tp.fft_sharded(torch.as_tensor(x), mesh)
    back = _np(tp.ifft_sharded(spec, mesh))
    np.testing.assert_allclose(back.real, x, atol=2e-3)
    s = _np(spec)[:, np.argsort(_cyclic(n, 8))]    # natural bin order
    np.testing.assert_allclose(np.abs(s[:, [12345, n - 12345]]), n / 2,
                               rtol=1e-3)
    assert np.abs(s).max() < 0.5001 * n
    others = np.delete(np.abs(s), [12345, n - 12345], axis=-1)
    assert others.max() < 1e-3 * n


def test_filtfilt_sharded_wide_halo(sig):
    """taps - 1 = 1024 > the 512-sample block: the halo takes two rounds
    and the edges are gathered against the global signal."""
    h = np.asarray(jfir.design_lowpass(1025, 0.25))
    got = tp.filtfilt_fir_sharded(h, torch.as_tensor(sig), mesh_of((1, 8)))
    close(got, jfir.filtfilt_fir(jnp.asarray(h), jnp.asarray(sig)), 5e-4)


@pytest.mark.parametrize("n", [512, 1024])
def test_savgol_sharded_wide_halo(sig, n):
    """half = 128 above the 64-sample block (n = 512: two rounds, the
    gather against the global edges; the port equals the JAX dense and the
    JAX sharded function there), and equal to the 128-sample block
    (n = 1024), where 'reflect' reads the neighbour's sample and takes the
    gather path."""
    x = sig[:, :n]
    want = jsg.savgol_filter(jnp.asarray(x), 257, 3)
    got = tp.savgol_filter_sharded(torch.as_tensor(x), 257, 3,
                                   mesh_of((1, 8)))
    close(got, want, 1e-3)
    if n == 512:
        close(got, jpops.savgol_filter_sharded(jnp.asarray(x), 257, 3,
                                               jmesh.make_mesh(1, 8)), 1e-3)


def test_sharded_edge_validation(sig):
    """The geometries the JAX functions refuse."""
    mesh = mesh_of((1, 8))
    x = torch.as_tensor(sig)
    with pytest.raises(ValueError):          # window longer than the signal
        tp.savgol_filter_sharded(x, 2 * 4096 + 1, 3, mesh)
    with pytest.raises(ValueError):
        tp.filtfilt_fir_sharded(np.ones(4097), x, mesh)
    with pytest.raises(ValueError):
        tp.resample_poly_sharded(x[:, :4000], 4, 3, mesh)
    with pytest.raises(ValueError):
        tp.stft_process_sharded(x[:, :4000], 256, 64, mesh)
    with pytest.raises(ValueError):
        tp.fir_apply_sharded(np.ones(3), x[:, :4001], mesh)
    assert tp.resample_poly_sharded(x, 3, 3, mesh).gather().equal(x)


@pytest.mark.parametrize("nfft,hop", [(512, 160), (384, 96)])
def test_stft_sharded_nondivisible_hop(sig, nfft, hop):
    """hop not dividing nfft (512/160: the gather framing and the padded
    overlap-add) and a non-power-of-two nfft (384/96, framed rfft)."""
    mesh = mesh_of((1, 8))
    n = 4096 // (8 * hop) * 8 * hop
    x = sig[:, :n]
    want = jax_stft(nfft, hop, n)
    got = tp.stft_process_sharded(torch.as_tensor(x), nfft, hop, mesh)
    nf = min(want.shape[-2], got.shape[-2])
    close(_np(got)[..., :nf, :], want[..., :nf, :], 1e-4)
    out = _np(tp.stft_reconstruct_sharded(got, nfft, hop, mesh))
    close(out[..., nfft:n - nfft], x[..., nfft:n - nfft], 5e-4)


def test_stft_sharded_pad_ragged_length(sig):
    mesh = mesh_of((1, 8))
    x = torch.as_tensor(sig[:, :4096 - 100])
    with pytest.raises(ValueError):
        tp.stft_process_sharded(x, 256, 64, mesh)
    got = _np(tp.stft_process_sharded(x, 256, 64, mesh, pad=True))
    want = np.asarray(JSTFT(256, 64).process(
        jnp.pad(jnp.asarray(sig[:, :3996]), [(0, 0), (0, 100)]), rfft=True))
    nf = min(want.shape[-2], got.shape[-2])
    close(got[..., :nf, :], want[..., :nf, :], 1e-4)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_stft_shards_run_the_kernel_or_its_plain_version(sig, shape,
                                                         monkeypatch):
    """Where stockham_supported takes the geometry, every shard's spectrum
    comes from stft_spectrum_stockham (its plain version on a CPU tensor):
    c*b calls a sharded STFT, equal to the framed rfft at 1e-5; elsewhere
    (384/96) none."""
    calls = []
    plain = tstk.stft_spectrum_stockham_plain

    def spy(x, *args, **kw):
        calls.append(tuple(x.shape))
        assert x.is_contiguous()
        return plain(x, *args, **kw)

    monkeypatch.setattr(tstk, "stft_spectrum_stockham_plain", spy)
    mesh = mesh_of(shape)
    got = tp.stft_process_sharded(torch.as_tensor(sig), 1024, 256, mesh)
    c, b = shape
    assert calls == [(8 // c, 4096 // b + 768)] * (c * b)
    xs = tp.shard(torch.as_tensor(sig), mesh)
    win = torch.tensor(get_window_np("hann", 1024), dtype=torch.float32)
    for row, rows_out in zip(xs.shards, got.shards):
        right = thalo.halo_from_right(list(row), 768)
        for xb, r, sb in zip(row, right, rows_out):
            frames = torch.cat([xb, r], -1).unfold(-1, 1024, 256)
            torch.testing.assert_close(sb, torch.fft.rfft(frames * win),
                                       rtol=1e-5, atol=1e-5 * 32)
    calls.clear()
    tp.stft_process_sharded(torch.as_tensor(sig[:, :3072]), 384, 96, mesh)
    assert calls == []


def test_stft_sharded_gradient_matches_dense(sig):
    """The shard's kernel call takes the framed transform's autograd rule:
    the gradient through the sharded STFT equals the dense STFT's."""
    mesh = mesh_of((2, 4))
    gen = np.random.default_rng(5)
    w = torch.as_tensor(gen.standard_normal((8, 14, 513)),
                        dtype=torch.float32)
    xa = torch.as_tensor(sig).requires_grad_(True)
    spec = tp.stft_process_sharded(xa, 1024, 256, mesh).gather()[:, :14]
    (spec.abs().square() * w).sum().backward()
    xb = torch.as_tensor(sig).requires_grad_(True)
    dense = STFT(1024, 256).process(xb, rfft=True)
    assert dense.shape[-2] == 14
    (dense.abs().square() * w).sum().backward()
    scale = xb.grad.abs().max().item()
    assert (xa.grad - xb.grad).abs().max().item() < 1e-5 * scale


# ---- the models ----

@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_northstar_sharded_matches_jax_dense(shape):
    """The flagship chain (1024-tap FIR, 4/3, 2048/512, 80 mels, 20 MFCCs)
    sharded, fused halos and staged, against the JAX dense chain at 2e-3 of
    scale, and fused against staged at 2e-4 of scale."""
    x, want = jax_chain()
    chain = NorthStarChain(device="cpu")
    mesh = mesh_of(shape)
    fused = _np(chain.apply_sharded(torch.as_tensor(x), mesh))
    staged = _np(chain.apply_sharded(torch.as_tensor(x), mesh,
                                     fuse_halos=False))
    nf = want.shape[-2]
    assert fused.shape == staged.shape == (2, N_CHAIN * 4 // 3 // 512, 20)
    scale = np.abs(want).max()
    np.testing.assert_allclose(fused[:, :nf], want, rtol=0,
                               atol=2e-3 * scale)
    np.testing.assert_allclose(staged[:, :nf], want, rtol=0,
                               atol=2e-3 * scale)
    np.testing.assert_allclose(fused, staged, rtol=0, atol=2e-4 * scale)


def test_northstar_sharded_matches_jax_sharded(monkeypatch):
    """The port's fused sharded chain against the JAX fused sharded chain
    on a 1x8 mesh at 2e-4 of scale (their fused-vs-staged limit); a
    geometry the fused head refuses gives way to the staged path, which
    refuses it too (its STFT needs whole hops in every shard)."""
    x, want = jax_chain()
    chain = NorthStarChain(device="cpu")
    got = _np(chain.apply_sharded(torch.as_tensor(x), mesh_of((1, 8))))
    jgot = np.asarray(JChain().apply_sharded(jnp.asarray(x),
                                             jmesh.make_mesh(1, 8)))
    assert got.shape == jgot.shape
    np.testing.assert_allclose(got, jgot, rtol=0,
                               atol=2e-4 * np.abs(want).max())
    used = []
    monkeypatch.setattr(chain, "_apply_sharded_fused",
                        lambda *a: used.append(a))
    xr = torch.as_tensor(x[:, :8 * 3 * 100])  # 400 resampled per shard
    with pytest.raises(ValueError, match=r"n_block_shards \* hop"):
        chain.apply_sharded(xr, mesh_of((1, 8)))
    assert used == []


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_spectral_gate_sharded_matches_dense(shape):
    """SpectralGate.apply_sharded against the JAX dense gate and the port's
    dense gate on the interior, as tests/test_models.py holds the JAX
    sharded gate; its output is time-sharded and cut back to n."""
    x = np.random.default_rng(1234).standard_normal(
        (8, 12288)).astype(np.float32)
    gate = SpectralGate(nfft=512, hop=128, threshold=0.2, device="cpu")
    got = gate.apply_sharded(torch.as_tensor(x), mesh_of(shape))
    assert got.shape == (8, 12288) and got.axis == -1
    got = _np(got)
    n = x.shape[-1]
    want = np.asarray(JGate(nfft=512, hop=128, threshold=0.2)(
        jnp.asarray(x)))
    close(got[:, :n - 512], want[:, :n - 512], 1e-3)
    close(got[:, :n - 512], gate(torch.as_tensor(x)).numpy()[:, :n - 512],
          1e-3)


def test_spectral_gate_sharded_threshold_zero_is_identity():
    x = np.random.default_rng(9).standard_normal((2, 8192)).astype(
        np.float32)
    gate = SpectralGate(threshold=0.0, device="cpu")
    close(gate.apply_sharded(torch.as_tensor(x), mesh_of((2, 4))), x, 5e-4)


def test_dryrun_multichip_runs_on_cpu():
    from vv_dsp_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8, device="cpu")
