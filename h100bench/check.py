"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference of the cell's configuration (``reference/<config>.py``, float64)
is worked out on the same inputs the program was given, in blocks of rows,
and each answer kept from the window is held to it:

- a closed loop's answers are the calls the sampler kept (a seeded sample
  and the last call), each compared whole;
- a stream's answer is every block's frames, in order, from the state the
  window started with.

Each number compared has its limit in the reference module's ``LIMITS``.
"""

from __future__ import annotations

import collections
import math

import torch

from h100bench.reference.common import MaxError

ROWS = 8


def compare_calls(ref, fields: dict, pool: list, got: list,
                  device: torch.device) -> tuple[dict, list[dict]]:
    """got: (pool index, fn(rows slice) -> the answer's rows). Returns
    the worst of each number over the answers and each answer's own."""
    accs = [MaxError() for _ in got]
    by_pool = collections.defaultdict(list)
    for k, (p, _) in enumerate(got):
        by_pool[p].append(k)
    for p, ks in sorted(by_pool.items()):
        x = pool[p].to(device)
        for r0 in range(0, x.shape[0], ROWS):
            rows = slice(r0, r0 + ROWS)
            want = ref.call(fields, x[rows])
            for k in ks:
                accs[k].add(got[k][1](rows), want)
            del want
    each = [a.numbers() for a in accs]
    return _worst(each), each


def compare_stream(ref, fields: dict, blocks: torch.Tensor, outputs: list,
                   device: torch.device) -> tuple[dict, list[dict]]:
    """blocks: (K, c, block) the window's input; outputs: K (c, frames,
    n_mfcc) answers. Returns the numbers over the whole stream and each
    block's own (of the whole stream's scale)."""
    k, c, b = blocks.shape
    x = blocks.to(device).permute(1, 0, 2).reshape(c, k * b)
    got = torch.cat(outputs, dim=-2)
    want = torch.cat([ref.stream(fields, x[r0:r0 + ROWS], b)
                      for r0 in range(0, c, ROWS)], dim=0)
    acc = MaxError()
    acc.add(got, want)
    diff = (got.double() - want).abs()
    per = diff.reshape(c, k, -1, diff.shape[-1]).amax(dim=(0, 2, 3))
    each = [{"err_of_scale": float(d / acc.scale)} for d in per]
    return acc.numbers(), each


def _worst(each: list[dict]) -> dict:
    """The largest of each number over the answers; NaN if any is NaN."""
    return {name: max((e[name] for e in each),
                      key=lambda v: math.inf if math.isnan(v) else v)
            for name in each[0]}


def verdict(limits: dict, numbers: dict, each: list[dict]) -> tuple:
    """(correct, answers over a limit, {name: {"value", "limit"}})."""
    checks = {name: {"value": numbers[name], "limit": lim}
              for name, lim in limits.items()}
    failed = sum(not all(e[n] < lim for n, lim in limits.items())
                 for e in each)
    correct = all(numbers[n] < lim for n, lim in limits.items())
    return correct, failed, checks
