"""Weak-scaling sweep over N processes of the port (the twin of
``scripts/run_scaling_report.py``): for each N, N ``launch_multihost``
processes joined in one gloo group over a global mesh, and N independent
``--local-only`` processes doing the same per-device work with no
communication, each configuration ``--repeats`` times, keeping the best.

Weak scaling: the per-device signal length is held, so ideal scaling is
throughput(N) = N * throughput(1); efficiency(N) = msps(N) / (N *
msps(1)), and comm efficiency = sharded / independent throughput at the
same N.

  python -m vv_dsp_tpu_torch.tools.run_scaling_report [--procs 1 2 4 8]
      [--per-device-samples 196608] [--out build/scaling_report_torch.json]
      [--cpu]

On the card every process takes ``cuda:{rank % device_count}`` (one card:
all N processes share it, each with its own CUDA context, time-sliced by
the card); with ``--cpu`` the CPU. Halos cross processes through host
memory over gloo. The report is written under the checkout's ``build/``
by default, never over ``benchmarks/scaling_report.json`` (the JAX
package's record).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "scaling_report_torch.json")
WORKER_TIMEOUT_S = 1200


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now (for a group's
    coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_all(procs, timeout_s: float) -> list[int]:
    """Exit codes of procs: all of them, or, once one fails or timeout_s
    runs out, the rest killed (negative codes), so that a rank that fails
    never leaves the others waiting on it."""
    deadline = time.monotonic() + timeout_s
    while (any(p.poll() is None for p in procs)
           and not any(p.poll() for p in procs)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
    return [p.wait(timeout=60) for p in procs]


def run_config(n_procs: int, per_device: int, channels: int, workdir: str,
               local_only: bool = False, chain_mode: str = "staged",
               cpu: bool = False) -> dict:
    """One configuration's record: process 0's JSON for the group, or the
    sum of the N independent processes' throughputs."""
    out_paths = ([os.path.join(workdir, f"scaling_local_{n_procs}_{p}.json")
                  for p in range(n_procs)] if local_only
                 else [os.path.join(workdir, f"scaling_{n_procs}.json")])
    for p in out_paths:
        if os.path.exists(p):
            os.remove(p)
    # one compute thread (and, where there are cores enough, one core) a
    # process, so per-device resources stay constant as N grows
    ncores = os.cpu_count() or 1
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    port = free_port()
    procs = []
    for pid in range(n_procs):
        cmd = [sys.executable, "-m", "vv_dsp_tpu_torch.tools.launch_multihost",
               "--per-device-samples", str(per_device),
               "--channels", str(channels),
               "--json-out", out_paths[pid if local_only else 0],
               "--chain-mode", chain_mode]
        if cpu:
            cmd.append("--cpu")
        if local_only:
            cmd += ["--local-only", "--process-id", str(pid)]
        else:
            cmd += ["--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", str(n_procs),
                    "--process-id", str(pid)]
        if n_procs <= ncores and shutil.which("taskset"):
            cmd = ["taskset", "-c", str(pid % ncores)] + cmd
        quiet = pid if not local_only else 1
        # quiet workers to DEVNULL, not PIPE: an unread PIPE deadlocks once
        # a worker's output fills the pipe buffer
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=env,
            stdout=subprocess.DEVNULL if quiet else None,
            stderr=subprocess.STDOUT if quiet else None))
    rcs = wait_all(procs, WORKER_TIMEOUT_S)
    if any(rcs):
        raise RuntimeError(f"N={n_procs}: worker exit codes {rcs}")
    if local_only:
        # the ideal (no-communication) aggregate: the N runs summed
        out = {"n_processes": n_procs, "fir_msps": 0.0, "chain_msps": 0.0}
        for p in out_paths:
            with open(p) as f:
                r = json.load(f)
            out["fir_msps"] += r["fir_msps"]
            out["chain_msps"] += r["chain_msps"]
        return out
    with open(out_paths[0]) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="run_scaling_report")
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--per-device-samples", type=int, default=196608)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--chain-mode", choices=["staged", "fused"],
                    default="staged")
    ap.add_argument("--repeats", type=int, default=3,
                    help="full-sweep repeats; each configuration keeps its "
                         "best throughput")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            sys.stderr.write("no CUDA device; pass --cpu\n")
            return 1
        from vv_dsp_tpu_torch import _build

        _build.build()       # once, before the workers start
    backend = ("torch.distributed gloo, halos staged through host memory; "
               + ("one process per simulated host on the CPU" if args.cpu
                  else "every process on cuda:{rank % device_count}, one "
                  "CUDA context each (one card: shared, time-sliced)"))

    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        for n in args.procs:
            t0 = time.time()
            sharded, local = [], []
            for _ in range(max(1, args.repeats)):
                sharded.append(run_config(
                    n, args.per_device_samples, args.channels, workdir,
                    chain_mode=args.chain_mode, cpu=args.cpu))
                local.append(run_config(
                    n, args.per_device_samples, args.channels, workdir,
                    local_only=True, chain_mode=args.chain_mode,
                    cpu=args.cpu))
            # each metric's best over the repeats
            r, lr = (dict(max(runs, key=lambda q: q["chain_msps"]),
                          fir_msps=max(q["fir_msps"] for q in runs))
                     for runs in (sharded, local))
            r["wall_s"] = round(time.time() - t0, 1)
            r["independent_fir_msps"] = lr["fir_msps"]
            r["independent_chain_msps"] = lr["chain_msps"]
            rows.append(r)
            print(f"N={n}: fir {r['fir_msps']:.0f} Msps "
                  f"(independent {lr['fir_msps']:.0f}), "
                  f"chain {r['chain_msps']:.0f} Msps "
                  f"(independent {lr['chain_msps']:.0f})", flush=True)

    base = rows[0]
    for r in rows:
        scale = r["n_processes"] / base["n_processes"]
        r["fir_efficiency"] = r["fir_msps"] / (scale * base["fir_msps"])
        r["chain_efficiency"] = r["chain_msps"] / (scale * base["chain_msps"])
        r["fir_comm_efficiency"] = r["fir_msps"] / r["independent_fir_msps"]
        r["chain_comm_efficiency"] = (r["chain_msps"]
                                      / r["independent_chain_msps"])
    report = {
        "mode": "weak",
        "chain_mode": args.chain_mode,
        "host_physical_cores": os.cpu_count(),
        "backend": backend,
        "per_device_samples": args.per_device_samples,
        "channels": args.channels,
        "repeats": args.repeats,
        "notes": "comm_efficiency = sharded throughput / N independent "
                 "no-communication processes on the same machine; it "
                 "separates the halo and gather cost from the processes' "
                 "contention for the host and the card.",
        "configs": rows,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    for r in rows:
        print(f"  N={r['n_processes']}: fir eff "
              f"{r['fir_efficiency']*100:.0f}% "
              f"(comm {r['fir_comm_efficiency']*100:.0f}%), chain eff "
              f"{r['chain_efficiency']*100:.0f}% "
              f"(comm {r['chain_comm_efficiency']*100:.0f}%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
