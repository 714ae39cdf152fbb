"""A global tensor split over a mesh: the port's counterpart of the sharded
``jax.Array`` that ``shard_map``'s in and out specs describe.

Axis 0 (channels) is split over the mesh's channel axis and one more axis,
``axis`` (time for a signal, frames for a spectrum), over its block axis;
``shards[i][j]`` holds channel block i and time block j on the grid's
device [i][j]. Every ``*_sharded`` function takes a global tensor or a
``ShardedTensor`` and returns a ``ShardedTensor``, so sharded ops chain
without a gather, as the JAX ones do (``stft_process_sharded``'s
frame-sharded spectrum goes straight into ``stft_reconstruct_sharded``).
"""

from __future__ import annotations

import torch

from vv_dsp_tpu_torch.parallel.mesh import Mesh


class ShardedTensor:
    """shards: rows (channel blocks) of tensors (time blocks); axis: the
    negative axis split over the block shards."""

    def __init__(self, shards, axis: int = -1):
        self.shards = tuple(tuple(row) for row in shards)
        if not self.shards or not self.shards[0]:
            raise ValueError("a ShardedTensor needs at least one shard")
        if axis >= 0:
            raise ValueError("axis must be negative (counted from the end)")
        self.axis = axis

    @property
    def devices(self) -> tuple[tuple[torch.device, ...], ...]:
        return tuple(tuple(s.device for s in row) for row in self.shards)

    @property
    def shape(self) -> tuple[int, ...]:
        """The global shape."""
        first = self.shards[0][0].shape
        shape = list(first)
        shape[0] = sum(row[0].shape[0] for row in self.shards)
        shape[self.axis] = sum(s.shape[self.axis] for s in self.shards[0])
        return tuple(shape)

    def uniform(self) -> bool:
        """Whether every shard has the same shape (the layout a sharded op
        takes)."""
        first = self.shards[0][0].shape
        return all(s.shape == first for row in self.shards for s in row)

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on `device` (the first shard's when None)."""
        device = self.shards[0][0].device if device is None else device
        rows = [torch.cat([s.to(device) for s in row], dim=self.axis)
                for row in self.shards]
        return torch.cat(rows, dim=0)

    def map(self, fn) -> ShardedTensor:
        """fn applied to every shard on its own device: for a function that
        acts on each position of the split axis alone (a gate per frame,
        a power, a mel projection), the sharded form of fn."""
        return ShardedTensor([[fn(s) for s in row] for row in self.shards],
                             self.axis)

    def crop(self, start: int, stop: int) -> ShardedTensor:
        """Positions [start, stop) of the split axis, each shard keeping
        what falls inside its block (the outer shards may shrink or
        empty)."""
        rows = []
        for row in self.shards:
            out, at = [], 0
            for s in row:
                length = s.shape[self.axis]
                lo = min(max(start - at, 0), length)
                hi = min(max(stop - at, 0), length)
                out.append(s.narrow(self.axis, lo, hi - lo))
                at += length
            rows.append(out)
        return ShardedTensor(rows, self.axis)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, axis={self.axis}, "
                f"grid={len(self.shards)}x{len(self.shards[0])})")


def shard(x, mesh: Mesh, axis: int = -1, channel_axis: str = "channel",
          block_axis: str = "block") -> ShardedTensor:
    """x split over mesh: axis 0 over channel_axis, `axis` over block_axis,
    each shard copied to its device. A ShardedTensor already laid out so is
    returned as it is; one laid out otherwise is gathered and split anew
    (as JAX reshards an input whose sharding differs from the spec)."""
    grid = mesh.grid(channel_axis, block_axis)
    if isinstance(x, ShardedTensor):
        if x.axis == axis and x.devices == grid and x.uniform():
            return x
        x = x.gather()
    nc, nb = len(grid), len(grid[0])
    c, n = x.shape[0], x.shape[axis]
    if c % nc:
        raise ValueError(f"{c} channels not divisible by {nc} channel "
                         "shards")
    if n % nb:
        raise ValueError(f"axis {axis} of length {n} not divisible by {nb} "
                         "block shards")
    rows = x.split(c // nc, dim=0)
    return ShardedTensor(
        [[s.to(dev) for s, dev in zip(row.split(n // nb, dim=axis), devs)]
         for row, devs in zip(rows, grid)], axis)
