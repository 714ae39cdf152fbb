"""The whole run, its look for a card skipped, with the timed path broken
underneath: ``correct`` has to come out false for every fault a cell can
have. Runs on the CPU at the cells' tiny shapes (the port's CPU path)."""

from __future__ import annotations

import pytest
import torch

from h100bench.tests.helpers import tiny_run


def half_left_out(call):
    """Only the first half of the batch is computed; the rest of the
    answer repeats it."""
    def f(x):
        keep = x.shape[0] // 2
        out = call(x[:keep])
        return torch.cat([out, out[:x.shape[0] - keep]], dim=0)
    return f


def answer_altered(call):
    """One value of every answer is off by 1% of the answer's scale."""
    def f(x):
        out = call(x).clone()
        flat = out.view(-1)
        flat[flat.numel() // 2] += 0.01 * out.abs().max()
        return out
    return f


def answer_nan(call):
    """One value of every answer is NaN."""
    def f(x):
        out = call(x).clone()
        out.view(-1)[0] = float("nan")
        return out
    return f


def stream_state_unchanged(step):
    def f(state, x):
        feats, _ = step(state, x)
        return feats, state
    return f


def stream_half_left_out(step):
    def f(state, x):
        feats, state = step(state, x)
        keep = feats.shape[0] // 2
        return torch.cat([feats[:keep], feats[:feats.shape[0] - keep]]), state
    return f


def stream_answer_altered(step):
    def f(state, x):
        feats, state = step(state, x)
        return answer_altered(lambda v: v)(feats), state
    return f


def stream_answer_nan(step):
    def f(state, x):
        feats, state = step(state, x)
        return answer_nan(lambda v: v)(feats), state
    return f


CASES = [
    ("chain.batch64", half_left_out),
    ("chain.batch64", answer_altered),
    ("stft.batch64", half_left_out),
    ("stft.batch64", answer_altered),
    ("stft.batch64", answer_nan),
    # one channel a clip: no half of a batch to leave out
    ("stft.clip1s", answer_altered),
    ("chain.stream1536", stream_state_unchanged),
    ("chain.stream1536", stream_half_left_out),
    ("chain.stream1536", stream_answer_altered),
    ("chain.stream1536", stream_answer_nan),
]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_fault_is_not_correct(name, fault):
    res = tiny_run(name, wrap=fault)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert any(c["value"] >= c["limit"] for c in res["checks"].values())
