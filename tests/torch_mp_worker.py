"""The sharded set of tests/test_torch_multiprocess.py, and the worker that
runs it as one rank of a process group.

``run_set(mesh)`` runs every sharded function of the port on
tests/test_torch_parallel.py's sizes and returns each gathered output;
the test runs it in one process on a mesh of ``[cpu] * 8`` devices and,
through this file run as a script, in each rank of a group whose ranks
hold some of the same positions:

    python tests/torch_mp_worker.py SPEC_JSON

SPEC_JSON names the rank, the group's size, how it meets (``init``: an
address for ``initialize_distributed``, or "env" for torchrun's
environment), the shards this process holds, the mesh shape and the file
the rank writes its outputs to (``torch.save``). It imports no jax.
"""

import json
import sys

import numpy as np
import torch

from vv_dsp_tpu_torch import parallel as tp
from vv_dsp_tpu_torch.models import NorthStarChain, SpectralGate
from vv_dsp_tpu_torch.ops.fir import design_lowpass_np, fir_apply
from vv_dsp_tpu_torch.ops.iir import butter_sos

N_CHAIN = 8 * 2048 * 3
GATE_N = 12288
FIR_TAPS = 64
FILTFILT_TAPS = 33
WIDE_TAPS = 2200        # on (1, 4), taps - 1 > 2 * t_local = 2048
TIMEOUT = 60.0          # seconds a rank waits for another


def inputs() -> dict:
    """The seeded numpy inputs, the same in every process."""
    return {
        "sig": np.random.default_rng(1234).standard_normal(
            (8, 4096)).astype(np.float32),
        "chain": np.random.default_rng(1234).standard_normal(
            (2, N_CHAIN)).astype(np.float32),
        "gate": np.random.default_rng(1234).standard_normal(
            (8, GATE_N)).astype(np.float32),
    }


def resample_len(nb: int) -> int:
    return 4096 // (nb * 3) * nb * 3


def run_set(mesh, wide: bool = False) -> dict:
    """Each sharded function's gathered output (every rank gathers); with
    wide, the FIR whose halo spans more than two
    blocks too."""
    data = {k: torch.as_tensor(v) for k, v in inputs().items()}
    x = data["sig"]
    nb = mesh.shape["block"]
    chain = NorthStarChain(device="cpu")
    gate = SpectralGate(nfft=512, hop=128, threshold=0.2, device="cpu")
    spec512 = tp.stft_process_sharded(x, 512, 128, mesh)
    spectrum = tp.fft_sharded(x[:, :1024], mesh)
    calls = {
        "fir": lambda: tp.fir_apply_sharded(
            design_lowpass_np(FIR_TAPS, 0.25), x, mesh),
        "channels": lambda: tp.shard_channels(x, mesh).map(
            lambda v: fir_apply(design_lowpass_np(FIR_TAPS, 0.25), v)),
        "iir": lambda: tp.iir_apply_sharded(butter_sos(4, 0.2), x, mesh),
        "stft": lambda: tp.stft_process_sharded(x, 1024, 256, mesh),
        "reconstruct": lambda: tp.stft_reconstruct_sharded(spec512, 512, 128,
                                                           mesh),
        "resample": lambda: tp.resample_poly_sharded(
            x[:, :resample_len(nb)], 4, 3, mesh),
        "savgol": lambda: tp.savgol_filter_sharded(x, 21, 3, mesh),
        "filtfilt": lambda: tp.filtfilt_fir_sharded(
            design_lowpass_np(FILTFILT_TAPS, 0.25), x, mesh),
        "fft": lambda: spectrum,
        "ifft": lambda: tp.ifft_sharded(spectrum, mesh),
        "hilbert": lambda: tp.hilbert_analytic_sharded(x, mesh),
        "cepstrum": lambda: tp.cepstrum_real_sharded(x[:, :2048] + 2.0,
                                                     mesh),
        "chain_fused": lambda: chain.apply_sharded(data["chain"], mesh),
        "chain_staged": lambda: chain.apply_sharded(data["chain"], mesh,
                                                    fuse_halos=False),
        "gate": lambda: gate.apply_sharded(data["gate"], mesh),
    }
    if wide:
        calls["fir_wide"] = lambda: tp.fir_apply_sharded(
            design_lowpass_np(WIDE_TAPS, 0.25), x, mesh)
    return {name: fn().gather() for name, fn in calls.items()}


def main(spec: dict) -> None:
    torch.set_num_threads(1)
    if spec["init"] == "env":
        tp.initialize_distributed(timeout=TIMEOUT)
    else:
        tp.initialize_distributed(spec["init"], spec["world"], spec["rank"],
                                  timeout=TIMEOUT)
    cpu = [torch.device("cpu")] * spec["shards"]
    mesh = tp.make_mesh(*spec["shape"], devices=cpu)
    out = run_set(mesh, wide=spec.get("wide", False))
    out["rank"] = tp.process_index()
    out["count"] = tp.process_count()
    out["owners"] = torch.tensor(mesh.owners)
    # each rank makes only its own shards from their global index
    shape = (8, 4096)
    made = tp.ShardedTensor.from_callback(
        shape, mesh, lambda idx: np.arange(32768, dtype=np.float32).reshape(
            shape)[idx] + 1e5 * tp.process_index())
    out["callback"] = made.gather()
    out["is_local"] = torch.tensor([[made.local(i, j) for j in range(
        len(row))] for i, row in enumerate(made.shards)])
    out["callback_local"] = sum(
        1 for i, row in enumerate(made.shards) for j, s in enumerate(row)
        if made.local(i, j) and s.device.type == "cpu")
    out["callback_meta"] = sum(1 for row in made.shards for s in row
                               if s.device.type == "meta")
    try:
        tp.make_mesh(3, 3, devices=cpu)
    except ValueError as e:
        out["mesh_error"] = str(e)
    torch.save(out, spec["out"])
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
