"""One program in N processes over one global mesh (the twin of
``scripts/launch_multihost.py``).

Every process runs the same command with its own ``--process-id``; they
meet at rank 0's address and form one gloo process group
(``parallel.initialize_distributed``). Each process holds
``--shards-per-process`` positions of a (1, N x shards) mesh on its card
(``cuda:{rank % device_count}``; ``--cpu``: the CPU), makes only its own
shards of the input from ``default_rng(process_index)``, and issues only
their work; halos cross processes through host memory. Without
``--coordinator`` the group comes from torchrun's environment where it is
set.

  python -m vv_dsp_tpu_torch.tools.launch_multihost \\
      --coordinator 127.0.0.1:9876 --num-processes 2 --process-id 0 &
  python -m vv_dsp_tpu_torch.tools.launch_multihost \\
      --coordinator 127.0.0.1:9876 --num-processes 2 --process-id 1 &

It runs the sharded 1,024-tap FIR and the sharded north-star chain over
the global mesh and prints each step's time on process 0; with
``VV_SCALING_STAGES`` set, the FIR, resampler and STFT stages too. A step
is timed from a barrier, after ``torch.cuda.synchronize()``, to a
barrier (CUDA events cannot span processes): the best of three trials'
means. ``--json-out`` takes the JAX script's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from vv_dsp_tpu_torch.tools import _cli


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="launch_multihost")
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's host:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--per-device-samples", type=int, default=None,
                    help="weak scaling: per-device signal length (overrides "
                         "--seconds; total n = n_devices * this)")
    ap.add_argument("--json-out", default=None,
                    help="process 0 writes {n_processes, n_devices, "
                         "samples, channels, fir_msps, chain_msps} JSON "
                         "here")
    ap.add_argument("--chain-mode", choices=["staged", "fused"],
                    default="staged", help="apply_sharded's halo strategy")
    ap.add_argument("--local-only", action="store_true",
                    help="no process group: the same per-device work on a "
                         "mesh of this process's own shards (the "
                         "no-communication baseline)")
    ap.add_argument("--shards-per-process", type=int, default=1,
                    help="mesh positions this process holds on its card")
    return ap


def main(argv=None) -> int:
    argv, device = _cli.take_device(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    dev = _cli.open_device(device)
    if dev is None:
        return 1
    from vv_dsp_tpu_torch import parallel as par
    from vv_dsp_tpu_torch.models import NorthStarChain
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np

    if args.coordinator:
        par.initialize_distributed(args.coordinator, args.num_processes,
                                   args.process_id)
    elif not args.local_only:
        par.initialize_distributed()
    rank = par.process_index()
    if dev.type == "cuda":
        slot = (args.process_id or 0) if args.local_only else rank
        dev = torch.device("cuda", slot % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    grouped = dist.is_initialized()
    mesh = par.make_mesh(1, devices=[dev] * args.shards_per_process)
    n_dev = mesh.shape["block"]
    if rank == 0:
        print(f"{par.process_count()} processes, {n_dev} devices, "
              f"mesh {dict(mesh.shape)}", flush=True)

    if args.per_device_samples is not None:
        per = args.per_device_samples - args.per_device_samples % (512 * 3)
        n = n_dev * per
    else:
        n = int(48000 * args.seconds)
        n -= n % (n_dev * 512 * 3)
    # each process makes only its own shards
    rng = np.random.default_rng(rank)

    def make_local(idx):
        shape = tuple(len(range(*s.indices(d)))
                      for s, d in zip(idx, (args.channels, n)))
        return rng.standard_normal(shape).astype(np.float32)

    x = par.ShardedTensor.from_callback((args.channels, n), mesh, make_local)

    def settle():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if grouped:
            dist.barrier()

    def timed(step_fn, iters=5, trials=3):
        """Best-of-trials mean step time, barrier to barrier."""
        step_fn(x)                      # kernel loads, gloo connections
        best = float("inf")
        for _ in range(trials):
            settle()
            t0 = time.perf_counter()
            for _ in range(iters):
                step_fn(x)
            settle()
            best = min(best, (time.perf_counter() - t0) / iters)
        return best

    h = design_lowpass_np(1024, 0.45)
    dt = timed(lambda v: par.fir_apply_sharded(h, v, mesh))
    fir_msps = args.channels * n / dt / 1e6
    if rank == 0:
        print(f"sharded 1024-tap FIR: {dt*1e3:.2f} ms/step, "
              f"{fir_msps:.0f} Msps ({fir_msps / n_dev:.0f} Msps/device)",
              flush=True)

    if os.environ.get("VV_SCALING_STAGES"):
        # per-stage timings (which stage limits weak scaling)
        stages = {
            "fir": lambda v: par.fir_apply_sharded(h, v, mesh),
            "resample": lambda v: par.resample_poly_sharded(v, 4, 3, mesh),
            "stft": lambda v: par.stft_process_sharded(v, 2048, 512, mesh),
        }
        for name, fn in stages.items():
            dt = timed(fn, iters=3, trials=1)
            if rank == 0:
                print(f"  stage {name}: {dt*1e3:.1f} ms", flush=True)

    chain = NorthStarChain(device=dev)
    dt = timed(lambda v: chain.apply_sharded(
        v, mesh, fuse_halos=(args.chain_mode == "fused")), iters=3)
    chain_msps = args.channels * n / dt / 1e6
    if rank == 0:
        print(f"sharded north-star chain: {dt*1e3:.2f} ms/step -> "
              f"{chain_msps:.0f} Msps input-rate", flush=True)
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump({"n_processes": par.process_count(),
                           "n_devices": n_dev, "samples": n,
                           "channels": args.channels,
                           "fir_msps": fir_msps,
                           "chain_msps": chain_msps}, f)
    if grouped:
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
