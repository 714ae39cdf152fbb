"""On the card: each cell's control comes out not correct and the program
correct, at the cell's own size, on three seeds each; and one short run of
each cell through the command. Marked ``cuda``; skips without a card.

    python3 -m pytest -p no:cacheprovider -m cuda h100bench/tests
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from h100bench import calibrate, harness
from h100bench.manifest import ROOT, Cell

pytestmark = pytest.mark.cuda
CELLS = ["chain.batch64", "stft.batch64", "chain.stream1536", "stft.clip1s"]
SECONDS = {"chain.stream1536": 4.0}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = Cell(name)
    entry = cell.traffic["entry"]
    limits = cell.reference().LIMITS[entry]
    control = cell.reference().CONTROL[entry]
    seconds = SECONDS.get(name, 1.0)
    prog = harness.Program(cell, card)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = calibrate.reading(cell, prog, seed, seconds, card)
        assert all(r[k] < lim for k, lim in limits.items()), r
    if control["kind"] == "program":
        prog = harness.Program(cell, card, control["fields"])
    for seed in (2**31 + 201, 2**31 + 202, 2**31 + 203):
        r = calibrate.reading(cell, prog, seed, seconds, card, control)
        assert any(r[k] >= lim for k, lim in limits.items()), r


@pytest.mark.parametrize("name", CELLS)
def test_run_through_the_command(card, name):
    r = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload",
                        name, "--seed", str(2**31 + 7), "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
