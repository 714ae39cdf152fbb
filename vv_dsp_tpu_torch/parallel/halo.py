"""Neighbour halo exchange over the block (time) axis (counterpart of
``vv_dsp_tpu/parallel/halo.py``).

Each function takes one channel row of block shards (a ``sharded.Row``,
block k on its own device, or a bare list of this process's tensors) and
returns one tensor per shard, on that shard's device, and a placeholder
(a meta tensor of its shape) at a position this process does not hold.
Where the JAX package ``ppermute``s, the port moves a slice to the
neighbour's device in one round of ``comm.exchange``: a device copy (or
none) between shards of one process, a transfer through host memory
between processes. The boundary
conditions are the JAX package's: zeros arrive at the outer shards (the
reference's zero initial filter history and zero padding past the signal
end), and the last shard's overlap-add spill is dropped.

Halos wider than one block take ceil(halo / t_local) rounds, round r
pulling from the block r places away, as the JAX exchange does.
"""

from __future__ import annotations

import torch

from vv_dsp_tpu_torch.parallel import comm
from vv_dsp_tpu_torch.parallel.sharded import Row


def _rounds(halo: int, t: int) -> list[int]:
    """Samples taken in each round r = 1, 2, ...: whole blocks, then the
    rest from the farthest one."""
    full, rest = divmod(halo, t)
    return [t] * full + ([rest] if rest else [])


def _zeros(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros(x.shape[:-1] + (n,))


def _placeholder(x: torch.Tensor, n: int) -> torch.Tensor:
    """A halo's stand-in at a position this process does not hold: made
    directly, since an op on meta tensors costs ~0.1 ms of host time."""
    return torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device="meta")


def _pull(row: Row, pieces) -> dict:
    """pieces: (k, r, source block index, the slice of it) for each part
    that block k takes in round r; returns {(k, r): the part on block k's
    device} for the blocks this process holds."""
    got = comm.exchange([(part, row.owners[src], row.owners[k],
                          row[k].device) for k, _, src, part in pieces])
    return {(k, r): g for (k, r, _, _), g in zip(pieces, got)
            if g is not None}


def halo_from_left(blocks, halo: int) -> list:
    """The `halo` samples preceding each block: (..., halo) per shard;
    shard 0's out-of-signal prefix is zeros."""
    row = blocks if isinstance(blocks, Row) else Row(blocks)
    nb = len(row)
    if halo == 0:
        return [b[..., :0] for b in row]
    if nb == 1:
        return [_zeros(row[0], halo) if row.local(0)
                else _placeholder(row[0], halo)]
    t = row[0].shape[-1]
    takes = _rounds(halo, t)
    got = _pull(row, [(k, r, k - r, row[k - r][..., t - need:])
                      for k in range(nb)
                      for r, need in enumerate(takes, start=1)
                      if k - r >= 0])
    out = []
    for k, b in enumerate(row):
        if not row.local(k):
            out.append(_placeholder(b, halo))
            continue
        parts = []                  # farther-left blocks go in front
        for r, need in enumerate(takes, start=1):
            parts.insert(0, got[k, r] if k - r >= 0 else _zeros(b, need))
        out.append(torch.cat(parts, dim=-1))
    return out


def halo_from_right(blocks, halo: int) -> list:
    """The `halo` samples following each block: (..., halo) per shard;
    the out-of-signal suffix on the last shards is zeros."""
    row = blocks if isinstance(blocks, Row) else Row(blocks)
    nb = len(row)
    if halo == 0:
        return [b[..., :0] for b in row]
    if nb == 1:
        return [_zeros(row[0], halo) if row.local(0)
                else _placeholder(row[0], halo)]
    t = row[0].shape[-1]
    takes = _rounds(halo, t)
    got = _pull(row, [(k, r, k + r, row[k + r][..., :need])
                      for k in range(nb)
                      for r, need in enumerate(takes, start=1)
                      if k + r < nb])
    return [torch.cat([got[k, r] if k + r < nb else _zeros(b, need)
                       for r, need in enumerate(takes, start=1)], dim=-1)
            if row.local(k) else _placeholder(b, halo)
            for k, b in enumerate(row)]


def spill_add_right(bufs, spills) -> list:
    """Overlap-add seam stitch: each shard's spill (..., L), the part of its
    accumulation that ran past its block, is added onto the blocks to its
    right, however many it spans, nearest block first, as the JAX
    exchange's rounds add it. The last shard's overflow is dropped (the
    reference clips OLA writes past the output buffer,
    src/core/framing.c:137-146). bufs carries the row's owners; spills
    holds placeholders where bufs does, and so does the result."""
    row = bufs if isinstance(bufs, Row) else Row(bufs)
    out = list(row)
    nb = len(out)
    if nb == 1:
        return out
    t = row[0].shape[-1]
    takes = _rounds(spills[0].shape[-1], t)
    got = _pull(row, [(k, r, k - r, spills[k - r][..., (r - 1) * t:r * t])
                      for r in range(1, len(takes) + 1)
                      for k in range(r, nb)])
    for r in range(1, len(takes) + 1):
        for k in range(r, nb):
            if row.local(k):
                seg = got[k, r]
                m = seg.shape[-1]
                out[k] = torch.cat([out[k][..., :m] + seg, out[k][..., m:]],
                                   dim=-1)
    return out
