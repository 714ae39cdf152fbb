"""WAV read and write (counterpart of ``vv_dsp_tpu/io/wav.py``; the
reference's audio module, src/audio/wav.c: RIFF chunk scan, PCM 16/24/32
and float32, planar buffers, a thread-local error string).

Two backends with the same semantics:
- native: the repository's codec ``csrc/wavio.cpp``, compiled with g++ on
  first use into ``build/vv_dsp_tpu_torch/wavio/<hash of the source and
  flags>/`` beside the CUDA kernels, and driven through ``ctypes``;
- numpy, where no C++ toolchain or source is found.

Decoding is host work: ``read_wav`` returns a float32 planar (channels,
frames) CPU tensor, which the caller moves to the card; ``write_wav`` takes
a tensor on any device (or an array). Integers map to [-1, 1) by
1/2^(bits-1), as the reference's converters (src/audio/wav.c:57-64).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

from vv_dsp_tpu_torch._build import BUILD_ROOT

# the repository's csrc/, the layout pyproject.toml's package data ships
_SRC = Path(__file__).resolve().parent.parent.parent / "csrc" / "wavio.cpp"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_LIB_NAME = "libvvdspwav.so"
_LIB_LOCK = threading.Lock()
_LIB = None
_LIB_TRIED = False


@dataclasses.dataclass(frozen=True)
class WavInfo:
    sample_rate: int
    channels: int
    bits: int
    is_float: bool
    frames: int


class _CInfo(ctypes.Structure):
    _fields_ = [("sample_rate", ctypes.c_uint32),
                ("channels", ctypes.c_uint32),
                ("bits", ctypes.c_uint32), ("format", ctypes.c_uint32),
                ("frames", ctypes.c_uint64)]


def _build_library() -> Path | None:
    """The codec's shared library, compiled unless one for this source and
    these flags exists; None without the source or a working g++."""
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    out_dir = BUILD_ROOT / "wavio" / digest.hexdigest()[:16]
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return lib
    try:
        out_dir.mkdir(parents=True, exist_ok=True)
        # compile into a temporary directory, then rename: a concurrent
        # process sees either no library or a whole one
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
            tmp = os.path.join(tmp_dir, _LIB_NAME)
            subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, str(_SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError):
        return None
    return lib


def _get_lib():
    """The loaded native codec, or None (the numpy backend)."""
    global _LIB, _LIB_TRIED
    with _LIB_LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        path = _build_library()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.vv_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_CInfo)]
        lib.vv_wav_info.restype = ctypes.c_int
        lib.vv_wav_read_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
            ctypes.c_uint32]
        lib.vv_wav_read_f32.restype = ctypes.c_int64
        lib.vv_wav_read_batch_f32.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint64, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int]
        lib.vv_wav_read_batch_f32.restype = ctypes.c_int
        lib.vv_wav_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int]
        lib.vv_wav_write.restype = ctypes.c_int
        lib.vv_wav_error_string.argtypes = []
        lib.vv_wav_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return _LIB


def _native_error(lib) -> str:
    return lib.vv_wav_error_string().decode("utf-8", "replace")


def _float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------------------------------------------------------------------
# numpy backend
# ---------------------------------------------------------------------------

def _parse_header_np(f):
    hdr = f.read(12)
    if len(hdr) != 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    while True:
        ch = f.read(8)
        if len(ch) != 8:
            raise ValueError("no data chunk found")
        cid, size = ch[:4], struct.unpack("<I", ch[4:])[0]
        if cid == b"fmt ":
            buf = f.read(size + (size & 1))
            if len(buf) < 16:
                raise ValueError("truncated fmt chunk")
            tag, channels, sr = struct.unpack("<HHI", buf[:8])
            bits = struct.unpack("<H", buf[14:16])[0]
            if tag == 0xFFFE and size >= 40 and len(buf) >= 26:
                tag = struct.unpack("<H", buf[24:26])[0]
            if channels == 0 or bits == 0 or sr == 0:
                raise ValueError(
                    f"invalid fmt chunk: channels={channels} bits={bits} "
                    f"sample_rate={sr}")
            fmt = (tag, channels, sr, bits)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            return fmt, size
        else:
            f.seek(size + (size & 1), os.SEEK_CUR)


def _read_np(path: str) -> tuple[np.ndarray, int]:
    """(float32 planar (channels, frames) numpy array, sample rate)."""
    with open(path, "rb") as f:
        (tag, channels, sr, bits), data_bytes = _parse_header_np(f)
        if not ((tag == 1 and bits in (16, 24, 32))
                or (tag == 3 and bits == 32)):
            raise ValueError(f"unsupported format: tag={tag} bits={bits}")
        frame_bytes = channels * bits // 8
        frames = data_bytes // frame_bytes
        raw = f.read(frames * frame_bytes)
        if len(raw) != frames * frame_bytes:
            raise ValueError(
                f"truncated data chunk: header promised {frames} frames "
                f"({frames * frame_bytes} bytes), file holds {len(raw)}")
    if tag == 3:
        data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif bits == 16:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 32:
        data = (np.frombuffer(raw, dtype="<i4").astype(np.float32)
                / 2147483648.0)
    else:  # 24-bit: each triplet into the top bytes of an int32, shifted
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        v = (b[:, 0].astype(np.int32) << 8 | b[:, 1].astype(np.int32) << 16
             | b[:, 2].astype(np.int32) << 24) >> 8
        data = v.astype(np.float32) / 8388608.0
    return data.reshape(frames, channels).T.copy(), int(sr)


def _write_np(path: str, planar: np.ndarray, sample_rate: int,
              fmt: int) -> None:
    channels, frames = planar.shape
    bits = 32 if fmt == 0 else fmt
    tag = 3 if fmt == 0 else 1
    inter = np.ascontiguousarray(planar.T)
    if tag == 3:
        payload = inter.astype("<f4").tobytes()
    else:
        lim = float(1 << (bits - 1))
        q = np.clip(np.rint(inter.astype(np.float64) * lim), -lim, lim - 1
                    ).astype(np.int32)
        if bits == 16:
            payload = q.astype("<i2").tobytes()
        elif bits == 32:
            payload = q.astype("<i4").tobytes()
        else:
            u = q.astype("<i4").view(np.uint8).reshape(-1, 4)
            payload = np.ascontiguousarray(u[:, :3]).tobytes()
    frame_bytes = channels * bits // 8
    pad = len(payload) & 1  # RIFF chunks are word-aligned
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload) + pad)
                + b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, tag, channels, sample_rate,
                            sample_rate * frame_bytes, frame_bytes, bits))
        f.write(b"data" + struct.pack("<I", len(payload)))
        f.write(payload)
        if pad:
            f.write(b"\x00")


# ---------------------------------------------------------------------------
# public API (vv_dsp_wav_read/write/info parity)
# ---------------------------------------------------------------------------

def wav_info(path) -> WavInfo:
    path = str(path)
    lib = _get_lib()
    if lib is not None:
        info = _CInfo()
        if lib.vv_wav_info(path.encode(), ctypes.byref(info)) != 0:
            raise ValueError(_native_error(lib))
        return WavInfo(info.sample_rate, info.channels, info.bits,
                       info.format == 3, info.frames)
    with open(path, "rb") as f:
        (tag, channels, sr, bits), data_bytes = _parse_header_np(f)
    return WavInfo(sr, channels, bits, tag == 3,
                   data_bytes // (channels * bits // 8))


def read_wav(path) -> tuple[torch.Tensor, int]:
    """Decode a WAV file -> (float32 planar (channels, frames) CPU tensor,
    sample_rate) (vv_dsp_wav_read, src/audio/wav.h:34-44)."""
    path = str(path)
    lib = _get_lib()
    if lib is None:
        data, sr = _read_np(path)
        return torch.from_numpy(data), sr
    info = _CInfo()
    if lib.vv_wav_info(path.encode(), ctypes.byref(info)) != 0:
        raise ValueError(_native_error(lib))
    out = np.empty((info.channels, info.frames), dtype=np.float32)
    rc = lib.vv_wav_read_f32(path.encode(), _float_ptr(out), info.frames,
                             info.channels)
    if rc < 0:
        raise ValueError(_native_error(lib))
    if rc != info.frames:
        # the file changed between info and read: fail rather than return
        # a buffer whose tail was never written
        raise ValueError(
            f"WAV decode returned {rc} frames, header promised "
            f"{info.frames} (file changed mid-read?)")
    return torch.from_numpy(out), int(info.sample_rate)


def write_wav(path, data, sample_rate: int, format: int = 16) -> None:
    """Encode float32 (channels, frames) or (frames,) to WAV; data is a
    tensor on any device or an array.

    format: 16/24/32 = PCM bit depth, 0 = IEEE float32
    (vv_dsp_wav_write, src/audio/wav.h:46-60)."""
    path = str(path)
    if isinstance(data, torch.Tensor):
        data = data.detach().to("cpu", torch.float32).numpy()
    planar = np.asarray(data, dtype=np.float32)
    if planar.ndim == 1:
        planar = planar[None, :]
    if planar.ndim != 2:
        raise ValueError("data must be (frames,) or (channels, frames)")
    if format not in (0, 16, 24, 32):
        raise ValueError("format must be 0 (float), 16, 24 or 32")
    lib = _get_lib()
    if lib is None:
        _write_np(path, planar, int(sample_rate), int(format))
        return
    planar = np.ascontiguousarray(planar)
    ch, frames = planar.shape
    rc = lib.vv_wav_write(path.encode(), _float_ptr(planar), ch, frames,
                          int(sample_rate), int(format))
    if rc != 0:
        raise ValueError(_native_error(lib))
