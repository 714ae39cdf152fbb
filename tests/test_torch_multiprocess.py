"""The port's sharded path in several processes: gloo process groups of 2
and 4 ranks spawned on the CPU, each rank holding some positions of a
mesh of CPU devices (tests/torch_mp_worker.py runs the set in each rank).

Layouts: (1, 8) as 2 processes x 4 shards, which meet at "host:port" on a
port bound to 0; (2, 4) as 4 x 2, each channel row split across two
processes, which meet at a file (``file://`` in a temporary directory, so
test workers never share a port); (1, 4) as 4 x 1 from torchrun's
environment, with the FIR at taps - 1 > 2 t_local, whose halo pulls from
blocks two and three processes away. The set holds halos, the IIR's
gathered offsets and the block DFT across processes, and
``shard_channels``' blocks, which every process owning part of a row
holds.

Each rank's gathered output is held two ways: against the port in one
process on the same mesh shape of ``[cpu] * 8`` (or 4) devices, to 1e-6 of
scale (the same per-shard ops on the same samples: every reading is 0),
and against the JAX package's functions on the same seeded numpy input at
tests/test_parallel.py's tolerances, as tests/test_torch_parallel.py
states them.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

import torch_mp_worker as worker
from torch_one_thread import one_thread
from vv_dsp_tpu_torch import parallel as tp
from vv_dsp_tpu_torch.ops.fir import design_lowpass_np
from vv_dsp_tpu_torch.ops.iir import butter_sos
from vv_dsp_tpu_torch.parallel.mesh import TORCHRUN_ENV
from vv_dsp_tpu_torch.tools.run_scaling_report import free_port, wait_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120.0
SINGLE_TOL = 1e-6
LAYOUTS = {
    "1x8_2proc": {"shape": (1, 8), "world": 2, "shards": 4,
                  "init": "host:port"},
    "2x4_4proc": {"shape": (2, 4), "world": 4, "shards": 2, "init": "file"},
    "1x4_4proc": {"shape": (1, 4), "world": 4, "shards": 1, "init": "env",
                  "wide": True},
}
NAMES = ["fir", "channels", "iir", "stft", "reconstruct", "resample", "savgol",
         "filtfilt", "fft", "ifft", "hilbert", "cepstrum", "chain_fused",
         "chain_staged", "gate"]
CASES = [(layout, name) for layout, spec in LAYOUTS.items()
         for name in NAMES + (["fir_wide"] if spec.get("wide") else [])]


def spawn(spec: dict, tmp) -> list[dict]:
    """Start the group's ranks, join them within JOIN_S (killing all as soon
    as one fails) and load each rank's outputs."""
    world = spec["world"]
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    port = free_port()
    init = {"host:port": f"127.0.0.1:{port}", "file": f"file://{tmp}/rdv",
            "env": "env"}[spec["init"]]
    procs, logs = [], []
    for rank in range(world):
        child = dict(env)
        if init == "env":
            child.update(RANK=str(rank), WORLD_SIZE=str(world),
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        args = {"rank": rank, "world": world, "init": init,
                "shards": spec["shards"], "shape": spec["shape"],
                "wide": spec.get("wide", False),
                "out": str(tmp / f"rank{rank}.pt")}
        logs.append(open(tmp / f"rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, worker.__file__, json.dumps(args)], cwd=REPO,
            env=child, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        rcs = wait_all(procs, JOIN_S)
    finally:
        for log in logs:
            log.close()
    if any(rcs):
        tails = [(tmp / f"rank{r}.log").read_text()[-2000:]
                 for r in range(world)]
        pytest.fail(f"ranks exited {rcs} (killed after {JOIN_S} s if "
                    f"negative):\n" + "\n".join(tails))
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """ranks(layout): each rank's outputs, the group spawned once."""
    @functools.lru_cache(maxsize=None)
    def get(layout: str) -> tuple:
        return tuple(spawn(LAYOUTS[layout],
                           tmp_path_factory.mktemp(layout)))
    return get


@functools.lru_cache(maxsize=None)
def single(layout: str) -> dict:
    """The port in this one process on the same mesh shape."""
    spec = LAYOUTS[layout]
    c, b = spec["shape"]
    mesh = tp.make_mesh(c, b, devices=[torch.device("cpu")] * (c * b))
    with one_thread():
        return worker.run_set(mesh, wide=spec.get("wide", False))


def _scale_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---- the JAX package's functions on the same numpy input ----

@functools.lru_cache(maxsize=None)
def jax_ref(name: str, nb: int):
    data = worker.inputs()
    x = jnp.asarray(data["sig"])
    if name in ("fir", "channels", "fir_wide"):
        taps = worker.WIDE_TAPS if name == "fir_wide" else worker.FIR_TAPS
        h = jnp.asarray(design_lowpass_np(taps, 0.25), jnp.float32)
        return np.asarray(jfir.fir_apply(h, x))
    if name == "iir":
        sos = butter_sos(4, 0.2)
        return np.asarray(jax.jit(lambda v: jiir.iir_apply(sos, v))(x))
    if name == "stft":
        return np.asarray(JSTFT(1024, 256).process(x, rfft=True))
    if name == "reconstruct":
        plan = JSTFT(512, 128)
        return np.asarray(plan.reconstruct(plan.process(x, rfft=True), 4096,
                                           rfft=True))
    if name == "resample":
        return np.asarray(jrs.resample_poly(x[:, :worker.resample_len(nb)],
                                            4, 3))
    if name == "savgol":
        return np.asarray(jsg.savgol_filter(x, 21, 3))
    if name == "filtfilt":
        h = jnp.asarray(design_lowpass_np(worker.FILTFILT_TAPS, 0.25),
                        jnp.float32)
        return np.asarray(jfir.filtfilt_fir(h, x))
    if name == "fft":
        return np.asarray(jfft.fft(x[:, :1024]))[:, _cyclic(1024, nb)]
    if name == "ifft":
        return np.asarray(jfft.ifft(jfft.fft(x[:, :1024])))
    if name == "hilbert":
        return np.asarray(jhil.hilbert_analytic(x))
    if name == "cepstrum":
        return np.asarray(jenv.cepstrum_real(x[:, :2048] + 2.0))
    if name in ("chain_fused", "chain_staged"):
        return np.asarray(JChain()(jnp.asarray(data["chain"])))
    if name == "gate":
        return np.asarray(JGate(nfft=512, hop=128, threshold=0.2)(
            jnp.asarray(data["gate"])))
    raise KeyError(name)


def _cyclic(n: int, nb: int) -> np.ndarray:
    """Global bin of each element of the cyclic layout, in shard order."""
    t = n // nb
    return np.concatenate([k1 + nb * np.arange(t) for k1 in range(nb)])


# tests/test_parallel.py's tolerances
JAX_TOL = {"fir": 2e-5, "channels": 2e-5, "fir_wide": 2e-5, "iir": 1e-4, "stft": 1e-4,
           "reconstruct": 5e-4, "resample": 2e-4, "savgol": 2e-4,
           "filtfilt": 5e-4, "hilbert": 1e-3, "cepstrum": 1e-3,
           "gate": 1e-3}
CHAIN_TOL, FUSED_STAGED_TOL = 2e-3, 2e-4
FFT_TOL = (2e-4, 2e-3)


@pytest.mark.parametrize("layout,name", CASES)
def test_equals_single_process(ranks, layout, name):
    """Every rank's gathered output against the port in one process on the
    same mesh shape: the same per-shard ops on the same samples."""
    want = single(layout)[name].numpy()
    for rank, out in enumerate(ranks(layout)):
        got = out[name].numpy()
        assert got.shape == want.shape
        err = _scale_err(got, want)
        print(f"{layout} {name} rank {rank}: {err:.3e} of scale")
        assert err <= SINGLE_TOL


@pytest.mark.parametrize("layout,name", CASES)
def test_matches_jax(ranks, layout, name):
    got = ranks(layout)[0][name].numpy()
    nb = LAYOUTS[layout]["shape"][1]
    want = jax_ref(name, nb)
    if name == "stft":
        # n // hop frames; the reference's extra frame here is zero
        nf = min(want.shape[-2], got.shape[-2])
        np.testing.assert_allclose(got[..., :nf, :], want[..., :nf, :],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(want[..., nf:, :], 0.0, atol=1e-6)
    elif name == "reconstruct":
        sig = worker.inputs()["sig"]
        for ref in (sig, want):
            np.testing.assert_allclose(got[..., 512:-512],
                                       ref[..., 512:-512], rtol=5e-4,
                                       atol=5e-4)
    elif name in ("fft", "ifft"):
        np.testing.assert_allclose(got, want, rtol=FFT_TOL[0],
                                   atol=FFT_TOL[1])
    elif name in ("hilbert",):
        for part in (np.real, np.imag):
            np.testing.assert_allclose(part(got), part(want), rtol=1e-3,
                                       atol=1e-3)
    elif name.startswith("chain"):
        nf = want.shape[-2]
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[:, :nf], want, rtol=0,
                                   atol=CHAIN_TOL * scale)
        other = ranks(layout)[0]["chain_fused"].numpy()
        np.testing.assert_allclose(got, other, rtol=0,
                                   atol=FUSED_STAGED_TOL * scale)
    elif name == "gate":
        n = worker.GATE_N
        np.testing.assert_allclose(got[:, :n - 512], want[:, :n - 512],
                                   rtol=1e-3, atol=1e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=JAX_TOL[name],
                                   atol=JAX_TOL[name])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gather_on_every_rank(ranks, layout):
    """gather() is a collective: every rank gets the same global tensor."""
    outs = ranks(layout)
    names = [n for lay, n in CASES if lay == layout]
    for out in outs[1:]:
        for name in names:
            assert torch.equal(out[name], outs[0][name]), name


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_process_index_count_and_owners(ranks, layout):
    """Each rank knows its index and the count (torchrun's environment in
    the 1x4 layout); the grid is laid out rank-major, filled row by
    row."""
    spec = LAYOUTS[layout]
    c, b = spec["shape"]
    want = torch.arange(spec["world"]).repeat_interleave(
        spec["shards"]).reshape(c, b)
    for rank, out in enumerate(ranks(layout)):
        assert (out["rank"], out["count"]) == (rank, spec["world"])
        assert torch.equal(out["owners"], want)
        assert torch.equal(out["is_local"], want == rank)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_from_callback(ranks, layout):
    """Each rank makes only its own shards (jax.make_array_from_callback):
    the gathered tensor holds each position's slice as its owner made
    it, the other positions are placeholders."""
    spec = LAYOUTS[layout]
    c, b = spec["shape"]
    base = np.arange(32768, dtype=np.float32).reshape(8, 4096)
    owner = np.kron(np.arange(spec["world"]).repeat(spec["shards"])
                    .reshape(c, b), np.ones((8 // c, 4096 // b)))
    for out in ranks(layout):
        np.testing.assert_array_equal(out["callback"].numpy(),
                                      base + 1e5 * owner)
        assert out["callback_local"] == spec["shards"]
        assert out["callback_meta"] == c * b - spec["shards"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_of_the_wrong_size_raises_as_jax(ranks, layout):
    """A mesh whose product is not the global device count raises the JAX
    package's ValueError."""
    spec = LAYOUTS[layout]
    n = spec["world"] * spec["shards"]
    with pytest.raises(ValueError) as jax_error:
        jmesh.make_mesh(3, 3, devices=jax.devices()[:n])
    for out in ranks(layout):
        assert out["mesh_error"] == str(jax_error.value)
