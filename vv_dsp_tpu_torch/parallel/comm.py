"""The transport between the processes of a mesh: the port's counterpart
of the collectives that ``shard_map`` emits (``lax.ppermute``,
``lax.all_gather``, ``psum_scatter``).

Everything is a round of point-to-point moves. Each move is (source
tensor, source rank, destination rank, destination device); every rank
builds the same list of moves from the global layout (the mesh's owners
and the shards' shapes), so sends and receives pair with no handshake,
and each move is tagged with its place in the list, so that two moves
between the same pair of ranks in one round cannot cross. A move inside
one process is a device copy, as in a single-process mesh. A move
between processes goes over the process group (gloo): the tensor is
staged to contiguous host memory (pinned when it comes from the card),
sent with ``batch_isend_irecv``, and copied to the destination shard's
device after ``wait()``. Gloo takes CPU tensors only and one GPU takes
no two NCCL ranks, so host staging is the design of this transport, not
a fallback: the shards' work stays on their devices.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vv_dsp_tpu_torch.parallel.mesh import process_index


def _wire(t: torch.Tensor) -> torch.Tensor:
    """What goes over the wire: complex as its real pairs (gloo has no
    complex types)."""
    return torch.view_as_real(t) if t.is_complex() else t


def _host_buffer(like: torch.Tensor, pinned: bool) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=pinned)


def exchange(moves) -> list:
    """One round of moves: ``(src, src_rank, dst_rank, dst_device)`` each,
    where src is the tensor to move where src_rank is this process and a
    placeholder of its shape and dtype (a meta tensor) elsewhere, and
    dst_device is used where dst_rank is this process. Every rank passes
    the same moves in the same order. Returns, for each move, the tensor
    on dst_device where dst_rank is this process, else None.
    ``exchange.bytes`` counts the bytes this process sent to others."""
    me = process_index()
    out = [None] * len(moves)
    ops, landing = [], []
    for tag, (src, src_rank, dst_rank, device) in enumerate(moves):
        if src_rank == me and dst_rank == me:
            out[tag] = src.to(device)
        elif src_rank == me:
            wire = _wire(src)
            buf = _host_buffer(wire, src.device.type == "cuda")
            buf.copy_(wire)
            exchange.bytes += buf.numel() * buf.element_size()
            ops.append(dist.P2POp(dist.isend, buf, dst_rank, tag=tag))
        elif dst_rank == me:
            buf = _host_buffer(_wire(src), torch.device(device).type
                               == "cuda")
            ops.append(dist.P2POp(dist.irecv, buf, src_rank, tag=tag))
            landing.append((tag, buf, src.is_complex(), device))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for tag, buf, is_complex, device in landing:
        got = torch.view_as_complex(buf) if is_complex else buf
        out[tag] = got.to(device)
    return out


exchange.bytes = 0


def all_gather(tensors, owners, device, ranks=None) -> list:
    """Every position's tensor on each rank among ranks (the owners when
    None; the row all-gather of ``lax.all_gather``, over the whole grid a
    gather): tensors are real where this process holds them and
    placeholders elsewhere. Returns them with the owners' copies received
    onto device; None at the positions of other processes where this one
    is not among ranks. Each tensor crosses from its owner to each other
    rank once."""
    me = process_index()
    ranks = sorted(set(owners)) if ranks is None else list(ranks)
    moves, where = [], []
    for k, (t, src) in enumerate(zip(tensors, owners)):
        for dst in ranks:
            if dst != src:
                moves.append((t, src, dst, device))
                where.append(k)
    out = [t if r == me else None for t, r in zip(tensors, owners)]
    for k, got in zip(where, exchange(moves)):
        if got is not None:
            out[k] = got
    return out
