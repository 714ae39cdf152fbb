"""The readings a cell's limits are set from, in one process on the card.

    python3 -m h100bench.calibrate --workload <name> --seconds <s> \
        --seeds <n,n,...> --control-seeds <n,n,...> [--out <file>]

For each seed: the cell's inputs, a window of ``seconds`` through the same
timed path as a run (``harness.window``) and every number the comparison
computes, whether or not it has a limit. Then the control of the cell's
entry (the reference module's ``CONTROL``) on the control seeds:

- ``program``: the program built with some fields at a lower precision;
- ``tf32``: the program with PyTorch's TF32 switched on for float32
  matmuls and convolutions;
- ``reference``: the reference module's ``control_call`` in the program's
  place, on the answers' inputs.

Prints one JSON line a reading (and appends it to ``--out``). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from h100bench import harness, loops
from h100bench.manifest import ROOT, Cell


@contextlib.contextmanager
def tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def reading(cell: Cell, prog, seed: int, seconds: float,
            device: torch.device, control: dict | None = None) -> dict:
    """One seed's numbers, of the program or of the cell's control."""
    inputs = loops.make_inputs(cell, seed, device, seconds)
    harness.warm_up(cell, prog, inputs)
    kind = control["kind"] if control else "program"
    if control and kind == "tf32":
        with tf32():
            rec = harness.window(cell, prog, inputs, seconds, seed, False)
    else:
        rec = harness.window(cell, prog, inputs, seconds, seed, False)
    ctl = cell.reference().control_call if kind == "reference" else None
    numbers, _ = harness.compare(cell, inputs, rec, device, ctl)
    return {"workload": cell.name, "seed": seed,
            "kind": "control." + kind if control else "program",
            "calls": rec["calls"], **numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = Cell(args.workload, ROOT)
    control = cell.reference().CONTROL[cell.traffic["entry"]]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    prog = harness.Program(cell, dev)
    runs = [(s, None) for s in seeds] + [(s, control) for s in cseeds]
    ctl_built = False
    for seed, ctl in runs:
        if ctl is not None and ctl["kind"] == "program" and not ctl_built:
            prog, ctl_built = harness.Program(cell, dev, ctl["fields"]), True
        line = json.dumps(reading(cell, prog, seed, args.seconds, dev, ctl))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
