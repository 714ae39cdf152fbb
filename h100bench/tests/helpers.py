"""Shared pieces of the harness's CPU tests: tiny shapes for each cell, so
that the whole run (set-up, window, check) drives the port's CPU path in a
second or two."""

from __future__ import annotations

import time

import torch

from h100bench import harness
from h100bench.manifest import Cell

CPU = torch.device("cpu")
SEED = 2**31 + 12345          # larger than 32 signed bits hold
TINY = {
    "chain.batch64": ({"channels": 2, "samples": 9600}, 0.4),
    "stft.batch64": ({"channels": 2, "samples": 9600}, 0.3),
    "stft.clip1s": ({"samples": 4800, "pool": 4}, 0.2),
    "chain.stream1536": ({"channels": 2}, 0.3),
}


def tiny_run(name: str, seed: int = SEED, wrap=None, trace=False) -> dict:
    """One run of the cell on the CPU at its tiny shape."""
    override, seconds = TINY[name]
    return harness.run_cell(Cell(name), seed, seconds, trace, CPU,
                            time.perf_counter(), wrap=wrap,
                            shape_override=override, log=lambda line: None)
