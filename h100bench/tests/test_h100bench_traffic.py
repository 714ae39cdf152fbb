"""The generator repeats exactly from a seed, gives every seed the same
sizes, and takes seeds past 32 bits; the sampler's draw repeats too."""

from __future__ import annotations

import pytest
import torch

from h100bench import loops
from h100bench.manifest import Cell
from h100bench.tests.helpers import CPU, SEED, TINY


@pytest.mark.parametrize("name", sorted(TINY))
def test_inputs_repeat_from_the_seed(name):
    cell = Cell(name)
    cell.traffic = dict(cell.traffic, **TINY[name][0])
    a = loops.make_inputs(cell, SEED, CPU, 0.2)
    b = loops.make_inputs(cell, SEED, CPU, 0.2)
    c = loops.make_inputs(cell, SEED + 1, CPU, 0.2)
    key = "pool" if cell.traffic["loop"] == "closed" else "blocks"
    ta, tb, tc = (torch.stack(list(d[key])) for d in (a, b, c))
    assert torch.equal(ta, tb)
    assert ta.shape == tc.shape and not torch.equal(ta, tc)


def test_full_shapes():
    cell = Cell("chain.batch64")
    assert (cell.channels(), cell.samples()) == (64, 479232)
    cell = Cell("stft.batch64")
    assert (cell.channels(), cell.samples()) == (64, 480000)
    cell = Cell("stft.clip1s")
    assert (cell.channels(), cell.samples()) == (1, 48000)
    cell = Cell("chain.stream1536")
    assert (cell.channels(), cell.samples()) == (16, 1536)
    assert loops.blocks_due(10, 1536, 48000.0) == 313


def test_sampler_repeats_and_keeps_the_last():
    def draw(seed):
        s = loops.Sampler(3, seed)
        for i in range(1000):
            s.offer(i, i % 2, torch.tensor(i))
        return [i for i, _, _ in s.answers()]

    assert draw(SEED) == draw(SEED)
    assert draw(SEED)[-1] == 999 and len(draw(SEED)) == 4
    assert draw(SEED) != draw(SEED + 1)


def test_drained_calls_and_their_reader():
    """The drained calls' spans are what host_ms_per_call.* read; a run
    without them (untraced) reads nothing."""
    cell = Cell("chain.batch64")
    spans = loops.Spans()
    inputs = {"args": [torch.zeros(3)], "pinned": False}
    made = loops.drained_calls(lambda x: x + 1, inputs, 0.05, CPU, spans)
    assert made == len(spans.of("issue_drained")) > 0
    rec = {"spans": spans, "traffic": cell.traffic}
    for name in ("host_ms_per_call.throughput", "host_ms_per_call.clip"):
        ms = cell.reader(name).read(rec)
        assert ms == pytest.approx(
            1e3 * sum(spans.of("issue_drained")) / made)
        assert cell.reader(name).read(
            {"spans": loops.Spans(), "traffic": cell.traffic}) is None

