"""Batch WAV ingest, the serving side's data loader (counterpart of
``vv_dsp_tpu/io/batch.py``).

A serving deployment feeds the card (files, channels, time) tensors of
many streams at once, so ingest decodes in parallel into one contiguous
planar buffer. Two backends with the same semantics:

- native: ``vv_wav_read_batch_f32`` in ``csrc/wavio.cpp``, whose std::thread
  pool fans the files out, each decoding straight into its (channels,
  capacity) slab of the shared output buffer (no per-file Python
  allocation, no GIL);
- numpy: a thread pool over the single-file numpy reader.

``prefetch_batches`` overlaps the decode of batch k+1 with the device's
work on batch k (one background thread, double-buffered).
"""

from __future__ import annotations

import ctypes
import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vv_dsp_tpu_torch.io import wav as _wav


@dataclasses.dataclass(frozen=True)
class WavBatch:
    """One decoded batch: ``data[i, :, :frames[i]]`` is file i (float32
    planar, a CPU tensor), zero-padded to the common capacity;
    ``frames[i] == -1`` marks a file that failed to decode (its rows are
    zero, ``rates[i] == 0``)."""

    data: torch.Tensor    # (n_files, channels, capacity) float32
    frames: torch.Tensor  # (n_files,) int64, decoded frames or -1
    rates: torch.Tensor   # (n_files,) int64 sample rates (0 on error)
    paths: tuple[str, ...]

    @property
    def ok(self) -> bool:
        return bool((self.frames >= 0).all())


def _probe_geometry(paths) -> tuple[int, int]:
    """(capacity_frames, channels) = the maxima over the decodable files."""
    cap = ch = 0
    for p in paths:
        try:
            info = _wav.wav_info(p)
        except (ValueError, OSError):
            continue  # the decode pass reports it per file
        cap = max(cap, info.frames)
        ch = max(ch, info.channels)
    if cap == 0 or ch == 0:
        raise ValueError("no decodable WAV file in the batch")
    return cap, ch


def read_wav_batch(paths, capacity_frames: int | None = None,
                   channels: int | None = None,
                   n_threads: int = 0) -> WavBatch:
    """Decode many WAV files into one (n_files, channels, capacity) float32
    planar tensor, in parallel.

    capacity_frames and channels default to the batch's maxima (probed from
    the headers). Longer files are cut to the capacity, shorter ones
    zero-padded; a file with fewer channels leaves the extra rows zero, and
    extra channels of a file are dropped. A file that fails to decode gets
    ``frames[i] == -1`` and zero rows: one bad file never poisons the
    batch. n_threads=0 means one per hardware thread (the native pool; up
    to 32 for the numpy one)."""
    paths = tuple(str(p) for p in paths)
    if not paths:
        raise ValueError("empty batch")
    if capacity_frames is None or channels is None:
        cap, ch = _probe_geometry(paths)
        capacity_frames = capacity_frames or cap
        channels = channels or ch
    capacity_frames = int(capacity_frames)
    channels = int(channels)
    if capacity_frames <= 0 or channels <= 0:
        raise ValueError("capacity_frames and channels must be positive")

    lib = _wav._get_lib()
    if lib is not None:
        out = np.empty((len(paths), channels, capacity_frames),
                       dtype=np.float32)
        frames = np.empty(len(paths), dtype=np.int64)
        rates = np.empty(len(paths), dtype=np.uint32)
        c_paths = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        lib.vv_wav_read_batch_f32(
            c_paths, len(paths), _wav._float_ptr(out), capacity_frames,
            channels, frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            rates.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            int(n_threads))
    else:
        out = np.zeros((len(paths), channels, capacity_frames),
                       dtype=np.float32)
        frames = np.full(len(paths), -1, dtype=np.int64)
        rates = np.zeros(len(paths), dtype=np.uint32)

        def one(i: int) -> None:
            try:
                data, sr = _wav._read_np(paths[i])
            except (ValueError, OSError):
                return
            ch = min(channels, data.shape[0])
            nf = min(capacity_frames, data.shape[1])
            out[i, :ch, :nf] = data[:ch, :nf]
            frames[i] = nf
            rates[i] = sr

        workers = n_threads if n_threads > 0 else min(32, len(paths))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(one, range(len(paths))))
    return WavBatch(torch.from_numpy(out), torch.from_numpy(frames),
                    torch.from_numpy(rates.astype(np.int64)), paths)


def prefetch_batches(path_batches, capacity_frames: int | None = None,
                     channels: int | None = None, n_threads: int = 0,
                     depth: int = 2):
    """Iterate ``WavBatch``es with the decode in the background: batch k+1
    (and up to `depth` ahead) decodes on a host thread while the consumer
    runs batch k on the device.

    ``for batch in prefetch_batches(chunks_of_paths):
    step(batch.data.to("cuda"))``"""
    batches = [tuple(b) for b in path_batches]
    if not batches:
        return
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = object()
    cancel = threading.Event()

    def put(item) -> bool:
        # a put that notices the consumer's cancellation: a plain q.put()
        # blocks forever when the consumer leaves the loop early, pinning
        # the thread and depth + 1 decoded batches for the process's life
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if cancel.is_set():
                    return
                if not put(read_wav_batch(b, capacity_frames, channels,
                                          n_threads)):
                    return
        except Exception as e:  # raised in the consumer, not the thread
            put(e)
            return
        put(stop)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        cancel.set()
        # drain so that a blocked put wakes at once, then reap the thread
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)
