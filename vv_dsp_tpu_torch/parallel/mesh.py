"""The device mesh of the sharded path and the processes that own it
(counterpart of ``vv_dsp_tpu/parallel/mesh.py``).

A mesh is a 2-D ``("channel", "block")`` grid of ``torch.device``s in
which a device may repeat: ``[cuda:0] * 8`` is 8 logical shards on one
card (the counterpart of the JAX tests' 8 virtual CPU devices), ``[cpu] *
8`` the tests' mesh. Where a machine has several GPUs the shards sit on
distinct cards, and a halo is a peer-to-peer copy.

One process drives every position of a mesh unless several processes run
the program, SPMD as under ``jax.distributed``: after
``initialize_distributed`` each process passes ``make_mesh`` its own
devices, the counts are gathered, and the global grid is laid out
rank-major (rank 0's devices first, then rank 1's, filled row by row).
Each position records its owning rank. A process holds the shards of its
own positions only and issues only their work; what crosses processes
goes through ``parallel.comm`` over gloo.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
import torch.nn.functional as F

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           timeout: float = 300.0) -> None:
    """Join num_processes processes into one gloo process group, this one
    as rank process_id (``jax.distributed.initialize``'s arguments).

    coordinator_address is JAX's ``"host:port"`` of rank 0; an address
    with a scheme (``tcp://``, ``file://``) is passed to torch.distributed
    as it is. With no arguments the group comes from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) where it is set, the counterpart of JAX's detection
    on a pod, and is a no-op otherwise: this process drives every device
    of a mesh. timeout (seconds) bounds the rendezvous and every later
    transfer, so a rank that fails makes the others raise, not hang. A
    second call with another size or rank raises."""
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        if not all(k in os.environ for k in TORCHRUN_ENV):
            return
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    elif None in (coordinator_address, num_processes, process_id):
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id together (or none of them)")
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if dist.is_initialized():
        have = (dist.get_world_size(), dist.get_rank())
        if have != (num_processes, process_id):
            raise RuntimeError(
                f"already initialized as rank {have[1]} of {have[0]}; "
                f"asked for rank {process_id} of {num_processes}")
        return
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))


def process_index() -> int:
    """This process's rank (``jax.process_index()``): 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (``jax.process_count()``): 1 without a
    group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (n0, n1) grid of devices named by ``axis_names``. ``shape`` maps
    each axis name to its size, as a JAX mesh's does; ``owners`` holds the
    rank that owns each position (this process's rank everywhere when
    None)."""

    def __init__(self, devices, shape: tuple[int, int],
                 axis_names: tuple[str, str] = ("channel", "block"),
                 owners=None):
        devices = [_device(d) for d in devices]
        n0, n1 = shape
        if n0 * n1 != len(devices):
            raise ValueError(f"mesh {n0}x{n1} != {len(devices)} devices")
        if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
            raise ValueError(f"need two distinct axis names, got "
                             f"{axis_names}")
        owners = ([process_index()] * len(devices) if owners is None
                  else list(owners))
        if len(owners) != len(devices):
            raise ValueError(f"{len(owners)} owners for {len(devices)} "
                             "devices")
        self.axis_names = tuple(axis_names)
        self.devices = tuple(tuple(devices[i * n1:(i + 1) * n1])
                             for i in range(n0))
        self.owners = tuple(tuple(owners[i * n1:(i + 1) * n1])
                            for i in range(n0))
        self.shape = dict(zip(self.axis_names, (n0, n1)))

    def _oriented(self, grid, channel_axis: str, block_axis: str):
        if {channel_axis, block_axis} != set(self.axis_names):
            raise ValueError(f"axes ({channel_axis!r}, {block_axis!r}) are "
                             f"not the mesh's {self.axis_names}")
        if channel_axis == self.axis_names[0]:
            return grid
        return tuple(zip(*grid))

    def grid(self, channel_axis: str = "channel",
             block_axis: str = "block") -> tuple[tuple[torch.device, ...],
                                                 ...]:
        """The devices with rows along channel_axis and columns along
        block_axis."""
        return self._oriented(self.devices, channel_axis, block_axis)

    def owner_grid(self, channel_axis: str = "channel",
                   block_axis: str = "block") -> tuple[tuple[int, ...], ...]:
        """The owning ranks, laid out as ``grid``."""
        return self._oriented(self.owners, channel_axis, block_axis)

    def __repr__(self) -> str:
        devs = [str(d) for row in self.devices for d in row]
        ranks = {r for row in self.owners for r in row}
        if len(ranks) == 1:
            return f"Mesh({self.shape}, devices={devs})"
        owners = [r for row in self.owners for r in row]
        return f"Mesh({self.shape}, devices={devs}, owners={owners})"


def make_mesh(n_channel_shards: int | None = None,
              n_block_shards: int | None = None, devices=None,
              axis_names: tuple[str, str] = ("channel", "block")) -> Mesh:
    """A 2-D (channel, block) mesh. A device may repeat. Defaults: all
    devices on the block (time) axis, channel = 1.

    In one process, `devices` are the mesh's, every CUDA device when None
    (raising without one: pass CPU devices to build a mesh on the CPU).
    Under a group of several processes every rank calls it (a
    collective): `devices` are this process's own, its card
    ``cuda:{rank % device_count}`` when None, and the global grid holds
    every rank's devices in rank order."""
    rank, world = process_index(), process_count()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass devices=[torch.device("
                               "'cpu')] * n to build a mesh on the CPU")
        count = torch.cuda.device_count()
        devices = ([torch.device("cuda", rank % count)] if world > 1 else
                   [torch.device("cuda", i) for i in range(count)])
    devices = [_device(d) for d in devices]
    owners = None
    if world > 1:
        everyone = [None] * world
        dist.all_gather_object(everyone, [str(d) for d in devices])
        devices = [torch.device(d) for mine in everyone for d in mine]
        owners = [r for r, mine in enumerate(everyone) for _ in mine]
    n_dev = len(devices)
    if n_channel_shards is None and n_block_shards is None:
        n_channel_shards, n_block_shards = 1, n_dev
    elif n_channel_shards is None:
        n_channel_shards = n_dev // n_block_shards
    elif n_block_shards is None:
        n_block_shards = n_dev // n_channel_shards
    return Mesh(devices, (n_channel_shards, n_block_shards), axis_names,
                owners)


def block_size(mesh: Mesh, n: int, block_axis: str = "block") -> int:
    """Per-shard length of a time axis of global length n (must divide)."""
    nb = mesh.shape[block_axis]
    if n % nb:
        raise ValueError(f"time length {n} not divisible by {nb} block "
                         "shards; pad with pad_to_blocks() first")
    return n // nb


def pad_to_blocks(x: torch.Tensor, mesh: Mesh, block_axis: str = "block",
                  axis: int = -1):
    """Right-pad the time axis with zeros to a multiple of the block-shard
    count. Returns (padded, original_len)."""
    nb = mesh.shape[block_axis]
    n = x.shape[axis]
    rem = (-n) % nb
    if rem == 0:
        return x, n
    pads = [0, 0] * (x.ndim - axis % x.ndim - 1) + [0, rem]
    return F.pad(x, pads), n
