"""The device mesh of the sharded path (counterpart of
``vv_dsp_tpu/parallel/mesh.py``).

``jax.shard_map`` is single-controller: one Python process drives every
device of the mesh, and the JAX tests run it on 8 virtual CPU devices. The
port is single-controller too. A mesh is a 2-D ``("channel", "block")``
grid of ``torch.device``s in which a device may repeat: ``[cuda:0] * 8``
is 8 logical shards on one card (the counterpart of the 8 virtual CPU
devices), ``[cpu] * 8`` the tests' mesh. Where a machine has several GPUs
the shards sit on distinct cards, and a halo is a peer-to-peer copy (over
NVLink where the cards have it). Several processes or hosts are not
ported yet (ROADMAP Queue 1, item 12).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """A no-op with no arguments, as on a single JAX process: this process
    drives every device of a mesh. With arguments it raises, since several
    processes are not ported yet."""
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        return
    raise NotImplementedError(
        "several processes or hosts are not ported yet (ROADMAP Queue 1, "
        "item 12); a mesh of this process's devices needs no set-up")


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (n0, n1) grid of devices named by ``axis_names``. ``shape`` maps
    each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices, shape: tuple[int, int],
                 axis_names: tuple[str, str] = ("channel", "block")):
        devices = [_device(d) for d in devices]
        n0, n1 = shape
        if n0 * n1 != len(devices):
            raise ValueError(f"mesh {n0}x{n1} != {len(devices)} devices")
        if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
            raise ValueError(f"need two distinct axis names, got "
                             f"{axis_names}")
        self.axis_names = tuple(axis_names)
        self.devices = tuple(tuple(devices[i * n1:(i + 1) * n1])
                             for i in range(n0))
        self.shape = dict(zip(self.axis_names, (n0, n1)))

    def grid(self, channel_axis: str = "channel",
             block_axis: str = "block") -> tuple[tuple[torch.device, ...],
                                                 ...]:
        """The devices with rows along channel_axis and columns along
        block_axis."""
        if {channel_axis, block_axis} != set(self.axis_names):
            raise ValueError(f"axes ({channel_axis!r}, {block_axis!r}) are "
                             f"not the mesh's {self.axis_names}")
        if channel_axis == self.axis_names[0]:
            return self.devices
        return tuple(zip(*self.devices))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for row in self.devices for d in row]})")


def make_mesh(n_channel_shards: int | None = None,
              n_block_shards: int | None = None, devices=None,
              axis_names: tuple[str, str] = ("channel", "block")) -> Mesh:
    """A 2-D (channel, block) mesh over `devices`, every CUDA device when
    None (raising without one: pass CPU devices to build a mesh on the
    CPU). A device may repeat. Defaults: all devices on the block (time)
    axis, channel = 1."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass devices=[torch.device("
                               "'cpu')] * n to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n_dev = len(devices)
    if n_channel_shards is None and n_block_shards is None:
        n_channel_shards, n_block_shards = 1, n_dev
    elif n_channel_shards is None:
        n_channel_shards = n_dev // n_block_shards
    elif n_block_shards is None:
        n_block_shards = n_dev // n_channel_shards
    return Mesh(devices, (n_channel_shards, n_block_shards), axis_names)


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
