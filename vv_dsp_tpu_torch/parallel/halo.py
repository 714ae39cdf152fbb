"""Neighbour halo exchange over the block (time) axis (counterpart of
``vv_dsp_tpu/parallel/halo.py``).

Each function takes one channel row of block shards (a list of tensors,
block k on its own device) and returns one tensor per shard, on that
shard's device. Where the JAX package ``ppermute``s, the port copies a
slice to the neighbour's device: peer to peer between two cards, a
device-local copy (or none) where shards share one. The boundary
conditions are the JAX package's: zeros arrive at the outer shards (the
reference's zero initial filter history and zero padding past the signal
end), and the last shard's overlap-add spill is dropped.

Halos wider than one block take ceil(halo / t_local) rounds, round r
pulling from the block r places away, as the JAX exchange does.
"""

from __future__ import annotations

import torch


def _rounds(halo: int, t: int) -> list[int]:
    """Samples taken in each round r = 1, 2, ...: whole blocks, then the
    rest from the farthest one."""
    full, rest = divmod(halo, t)
    return [t] * full + ([rest] if rest else [])


def _zeros(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros(x.shape[:-1] + (n,))


def halo_from_left(blocks, halo: int) -> list[torch.Tensor]:
    """The `halo` samples preceding each block: (..., halo) per shard;
    shard 0's out-of-signal prefix is zeros."""
    nb = len(blocks)
    if halo == 0:
        return [b[..., :0] for b in blocks]
    if nb == 1:
        return [_zeros(blocks[0], halo)]
    t = blocks[0].shape[-1]
    takes = _rounds(halo, t)
    out = []
    for k, b in enumerate(blocks):
        parts = []                  # farther-left blocks go in front
        for r, need in enumerate(takes, start=1):
            src = (blocks[k - r][..., t - need:].to(b.device) if k - r >= 0
                   else _zeros(b, need))
            parts.insert(0, src)
        out.append(torch.cat(parts, dim=-1))
    return out


def halo_from_right(blocks, halo: int) -> list[torch.Tensor]:
    """The `halo` samples following each block: (..., halo) per shard;
    the out-of-signal suffix on the last shards is zeros."""
    nb = len(blocks)
    if halo == 0:
        return [b[..., :0] for b in blocks]
    if nb == 1:
        return [_zeros(blocks[0], halo)]
    t = blocks[0].shape[-1]
    takes = _rounds(halo, t)
    out = []
    for k, b in enumerate(blocks):
        parts = [blocks[k + r][..., :need].to(b.device) if k + r < nb
                 else _zeros(b, need)
                 for r, need in enumerate(takes, start=1)]
        out.append(torch.cat(parts, dim=-1))
    return out


def spill_add_right(bufs, spills) -> list[torch.Tensor]:
    """Overlap-add seam stitch: each shard's spill (..., L), the part of its
    accumulation that ran past its block, is added onto the blocks to its
    right, however many it spans, nearest block first, as the JAX
    exchange's rounds add it. The last shard's overflow is dropped (the
    reference clips OLA writes past the output buffer,
    src/core/framing.c:137-146)."""
    out = list(bufs)
    nb = len(out)
    if nb == 1:
        return out
    t = out[0].shape[-1]
    for r, _ in enumerate(_rounds(spills[0].shape[-1], t), start=1):
        for k in range(r, nb):
            seg = spills[k - r][..., (r - 1) * t:r * t].to(out[k].device)
            m = seg.shape[-1]
            out[k] = torch.cat([out[k][..., :m] + seg, out[k][..., m:]],
                               dim=-1)
    return out
