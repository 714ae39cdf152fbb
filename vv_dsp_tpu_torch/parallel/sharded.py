"""A global tensor split over a mesh: the port's counterpart of the sharded
``jax.Array`` that ``shard_map``'s in and out specs describe.

Axis 0 (channels) is split over the mesh's channel axis and one more axis,
``axis`` (time for a signal, frames for a spectrum), over its block axis;
``shards[i][j]`` holds channel block i and time block j on the grid's
device [i][j]. Every ``*_sharded`` function takes a global tensor or a
``ShardedTensor`` and returns a ``ShardedTensor``, so sharded ops chain
without a gather, as the JAX ones do (``stft_process_sharded``'s
frame-sharded spectrum goes straight into ``stft_reconstruct_sharded``).

Under several processes (``mesh.initialize_distributed``) a process holds
real tensors at the positions it owns (``owners``) only, as a JAX process
holds its addressable shards (``shard_channels`` adds replicas, as JAX
replicates over the block axis); every other position keeps its shape
and dtype in a placeholder on the meta device, never data. ``gather`` is then
a collective, as ``multihost_utils.process_allgather`` is: every rank
calls it and every rank gets the global tensor.
"""

from __future__ import annotations

import torch

from vv_dsp_tpu_torch.parallel import comm
from vv_dsp_tpu_torch.parallel.mesh import (Mesh, process_count,
                                            process_index)


def _fill_remote(items) -> list:
    """items with each None (a position this process does not hold)
    replaced by a placeholder shaped as the first tensor among them: the
    shards of one sharded op share their shape. All None stays all
    None."""
    like = next((t for t in items if t is not None), None)
    if like is None:
        return list(items)
    return [like.to("meta") if t is None else t for t in items]


class Row(list):
    """One channel row of block shards, in block order, with the rank that
    owns each (``owners``; this process's everywhere when None). A
    position this process does not hold is a placeholder."""

    def __init__(self, shards, owners=None):
        super().__init__(shards)
        self.owners = (tuple(owners) if owners is not None
                       else (process_index(),) * len(self))

    def local(self, k: int) -> bool:
        return not self[k].is_meta

    def each(self, fn, *cols, keep: bool = False) -> list:
        """fn(k, shard k, col[k] for each col) at each position this
        process holds; None at the others (the ``ShardedTensor`` made of
        the list holds placeholders there), or with keep the position's
        own placeholder, for an fn that keeps shape and dtype."""
        return [(s if keep else None) if s.is_meta else fn(k, s, *args)
                for k, (s, *args) in enumerate(zip(self, *cols))]


class ShardedTensor:
    """shards: rows (channel blocks) of tensors (time blocks), None or a
    placeholder where this process does not hold the position; axis: the
    negative axis split over the block shards; owners: the rank whose copy
    of each position ``gather`` sends, laid out as shards (this process's
    everywhere when None). A position may be held by more processes than
    its owner (``shard_channels``' replicas)."""

    def __init__(self, shards, axis: int = -1, owners=None):
        rows = [list(row) for row in shards]
        if not rows or not rows[0]:
            raise ValueError("a ShardedTensor needs at least one shard")
        if axis >= 0:
            raise ValueError("axis must be negative (counted from the end)")
        flat = _fill_remote([s for row in rows for s in row])
        if flat[0] is None:
            raise ValueError("a ShardedTensor needs a shard in this process")
        n1 = len(rows[0])
        self.shards = tuple(tuple(flat[i * n1:(i + 1) * n1])
                            for i in range(len(rows)))
        me = process_index()
        self.owners = (tuple(tuple(row) for row in owners) if owners
                       is not None else tuple((me,) * n1 for _ in rows))
        self.axis = axis

    @property
    def devices(self) -> tuple[tuple[torch.device, ...], ...]:
        return tuple(tuple(s.device for s in row) for row in self.shards)

    def row(self, i: int) -> Row:
        """Channel row i with its owners."""
        return Row(self.shards[i], self.owners[i])

    def local(self, i: int, j: int) -> bool:
        """Whether this process holds position (i, j)."""
        return not self.shards[i][j].is_meta

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
        """The global tensor on `device` (the first shard of this process's
        when None). Where other processes hold shards every rank calls it
        and gets the global tensor: each shard crosses from its owner to
        every other rank once (``comm.all_gather``)."""
        flat = [s for row in self.shards for s in row]
        owners = [r for own in self.owners for r in own]
        if device is None:
            device = next(s.device for s in flat if not s.is_meta)
        got = comm.all_gather(flat, owners, device, range(process_count()))
        n1 = len(self.shards[0])
        return torch.cat([torch.cat([t.to(device) for t in got[i:i + n1]],
                                    dim=self.axis)
                          for i in range(0, len(got), n1)], dim=0)

    def map(self, fn) -> ShardedTensor:
        """fn applied to every shard of this process on its own device: for
        a function that acts on each position of the split axis alone (a
        gate per frame, a power, a mel projection), the sharded form of
        fn. A position this process does not hold takes the shape of this
        process's output from a shard of the same shape, else fn's output
        on its placeholder."""
        made = {}
        rows = []
        for row in self.shards:
            rows.append([None if s.is_meta else fn(s) for s in row])
            for s, out in zip(row, rows[-1]):
                if out is not None:
                    made.setdefault(s.shape, out)
        for row_in, row_out in zip(self.shards, rows):
            for j, s in enumerate(row_in):
                if row_out[j] is None:
                    like = made.get(s.shape)
                    row_out[j] = fn(s) if like is None else like.to("meta")
        return ShardedTensor(rows, self.axis, self.owners)

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
        return ShardedTensor(rows, self.axis, self.owners)

    @classmethod
    def from_callback(cls, global_shape, mesh: Mesh, fn, axis: int = -1,
                      channel_axis: str = "channel",
                      block_axis: str = "block") -> ShardedTensor:
        """The counterpart of ``jax.make_array_from_callback``: fn(index),
        index a tuple of slices of the global shape, gives the data of each
        position this process owns (an array or a tensor), copied to its
        device; no other position is made."""
        grid = mesh.grid(channel_axis, block_axis)
        owners = mesh.owner_grid(channel_axis, block_axis)
        nc, nb = len(grid), len(grid[0])
        c, n = global_shape[0], global_shape[axis]
        if c % nc or n % nb:
            raise ValueError(f"global shape {tuple(global_shape)} does not "
                             f"split over a {nc}x{nb} grid")
        tc, tn = c // nc, n // nb
        me = process_index()
        rows = []
        for i, (devs, own) in enumerate(zip(grid, owners)):
            row = []
            for j, (dev, r) in enumerate(zip(devs, own)):
                if r != me:
                    row.append(None)
                    continue
                index = [slice(0, d) for d in global_shape]
                index[0] = slice(i * tc, (i + 1) * tc)
                index[axis] = slice(j * tn, (j + 1) * tn)
                row.append(torch.as_tensor(fn(tuple(index)), device=dev))
            rows.append(row)
        return cls(rows, axis, owners)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, axis={self.axis}, "
                f"grid={len(self.shards)}x{len(self.shards[0])})")


def shard(x, mesh: Mesh, axis: int = -1, channel_axis: str = "channel",
          block_axis: str = "block") -> ShardedTensor:
    """x split over mesh: axis 0 over channel_axis, `axis` over block_axis,
    each shard of this process copied to its device. A ShardedTensor
    already laid out so is returned as it is; one laid out otherwise is
    gathered and split anew (as JAX reshards an input whose sharding
    differs from the spec)."""
    grid = mesh.grid(channel_axis, block_axis)
    owners = mesh.owner_grid(channel_axis, block_axis)
    me = process_index()
    if isinstance(x, ShardedTensor):
        if (x.axis == axis and x.owners == owners and x.uniform()
                and all(s.device == d
                        for row, devs, own in zip(x.shards, grid, owners)
                        for s, d, r in zip(row, devs, own) if r == me)):
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
        [[s.to(dev) if r == me else None
          for s, dev, r in zip(row.split(n // nb, dim=axis), devs, own)]
         for row, devs, own in zip(rows, grid, owners)], axis, owners)
