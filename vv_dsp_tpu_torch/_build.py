"""Build and load the port's hand-written CUDA kernels.

The kernels live as CUDA C++ under ``csrc/`` with a plain C interface. On
first use, ``library()`` compiles every ``csrc/*.cu`` with ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together (so
the build takes as long as the slowest source, not the sum of them, as
sources are added within chip_smoke.py's fixed time limit), links the
objects into one shared library under
``build/vv_dsp_tpu_torch/<hash of the sources and flags>/`` beside the
package, and loads it with ``ctypes``. A later process with the same
sources reuses the library. A failed build raises with nvcc's stderr.
Every kernel wrapper checks its rows with ``require_rows`` and calls its
entry through ``launch``: one call a run of ``row_chunks``, counted.

Nothing here runs at import: machines without ``nvcc`` (the CPU test
runs) import every module and never call ``library()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parent.parent / "build"
              / "vv_dsp_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libvv_dsp_kernels.so"
MAX_ROWS = 65535             # gridDim.y's limit
# csrc/filter.cu vv_poly: x, taps, offsets, y, rows, n_in, n_out, up, down,
# ncls, n_big, k, lo, row_len, q_pitch, p_pitch, frames, threads, smem,
# device, stream
POLY_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 13
                 + [ctypes.c_void_p])


def _sources() -> list[Path]:
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the port's "
                           "kernels are built with nvcc on first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path. The build log (nvcc -Xptxas -v: registers, shared
    memory and spills of every kernel) is kept beside it as build.log."""
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory, then rename the library: a concurrent
    # process sees either no library or a whole one
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        cus = [p for p in srcs if p.suffix == ".cu"]
        objs = [os.path.join(tmp_dir, p.stem + ".o") for p in cus]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o,
                                   str(p)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for p, o in zip(cus, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        tmp = os.path.join(tmp_dir, LIB_NAME)
        failed = [f"{p.name}:\n{log}" for p, proc, log in zip(cus, procs, logs)
                  if proc.returncode != 0]
        if not failed:
            r = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                               capture_output=True, text=True)
            logs.append(r.stdout + r.stderr)
            if r.returncode != 0:
                failed.append(f"link:\n{r.stdout + r.stderr}")
        (out_dir / "build.log").write_text("".join(logs))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return load(build())


def load(path) -> ctypes.CDLL:
    """The kernel library at path, its entry points typed. Each load of
    another file is a library of its own, with its own kernels and launch
    caches (csrc/fft_reg.cuh fr_launch)."""
    lib = ctypes.CDLL(str(path))
    P, I, L, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
    lib.vv_upfirdn.argtypes = [P, P, P, I, L, L, I, I, L, I, I, I, I, I, I,
                               I, I, I, I, I, I, L, I, I, P]
    lib.vv_stft_spectrum.argtypes = [P, P, P, P, P, I, L, I, I, I, I, I, I,
                                     P]
    lib.vv_stft_mfcc.argtypes = [P, P, P, P, P, P, P, P, I, L, I, I, I, I,
                                 I, I, F, I, I, I, L, I, P]
    lib.vv_stft_power.argtypes = [P, P, P, P, P, I, L, I, I, I, I, P]
    lib.vv_istft.argtypes = [P, P, P, P, P, P, I, I, I, I, L, I, F, L, I,
                             P, P]
    lib.vv_stockham_spectrum.argtypes = [P, P, P, P, I, L, I, I, I, I, I, P]
    lib.vv_stockham_power.argtypes = [P, P, P, P, I, L, I, I, I, I, P]
    lib.vv_stockham_mel.argtypes = [P, P, P, P, P, P, P, I, L, I, I, I, I,
                                    I, I, F, I, I, L, I, P]
    lib.vv_stockham_gate.argtypes = [P, P, P, P, P, I, L, I, I, I, F, L, I,
                                     P]
    lib.vv_fir_direct.argtypes = [P, P, P, I, L, I, I, P]
    lib.vv_poly.argtypes = POLY_ARGTYPES
    lib.vv_dft_power.argtypes = [P, P, P, I, L, I, I, I, I, I, I, I, I, P]
    lib.vv_istft_stockham.argtypes = [P, P, P, P, P, I, I, I, I, I, L, L, I,
                                      P]
    lib.vv_stft_gate_packed.argtypes = [P, P, P, P, P, P, I, L, I, I, I, F,
                                        L, I, P]
    lib.vv_fir_os.argtypes = [P, P, P, P, I, L, I, I, I, P]
    for fn in (lib.vv_upfirdn, lib.vv_stft_spectrum, lib.vv_stft_mfcc,
               lib.vv_stft_power, lib.vv_istft, lib.vv_stockham_spectrum,
               lib.vv_stockham_power, lib.vv_stockham_mel,
               lib.vv_stockham_gate, lib.vv_fir_direct, lib.vv_poly,
               lib.vv_dft_power, lib.vv_istft_stockham,
               lib.vv_stft_gate_packed, lib.vv_fir_os):
        fn.restype = I
    lib.vv_error_string.argtypes = [I]
    lib.vv_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry returned a CUDA error (the launch was
    refused or faulted)."""
    if err:
        msg = library().vv_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle(t) -> ctypes.c_void_p:
    """PyTorch's current stream on t's device, for a kernel entry."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t, row: int = 0) -> ctypes.c_void_p:
    """The address of row `row` (along dim 0) of contiguous tensor t; at row
    0, as every pointer of a one-launch call is, with no stride lookups."""
    off = row * t.stride(0) * t.element_size() if row else 0
    return ctypes.c_void_p(t.data_ptr() + off)


def row_chunks(rows: int) -> list[tuple[int, int]]:
    """(first row, rows) of each launch over `rows` >= 1 rows: runs of at
    most MAX_ROWS, the rows a kernel entry takes in one launch."""
    if rows < 1:
        raise ValueError(f"channels must be positive, got {rows}")
    return [(r0, min(MAX_ROWS, rows - r0))
            for r0 in range(0, rows, MAX_ROWS)]


def counted(op):
    """Declare kernel wrapper op's launch counter, op.launches = 0."""
    op.launches = 0
    return op


def target(t) -> tuple:
    """(library(), t's device index, ``stream_handle(t)``): what each
    launch of a call on t's device passes."""
    return library(), t.device.index, stream_handle(t)


def launch(op, channels: int, call) -> int:
    """Launch kernel wrapper op's entry over `channels` rows: call(r0, k)
    calls the entry on rows [r0, r0 + k) and returns its error code, once
    a run of ``row_chunks(channels)``, in order. An error raises under
    op's name; each launch adds one to op.launches. Returns the launches."""
    chunks = row_chunks(channels)
    for r0, rows in chunks:
        check(call(r0, rows), op.__name__)
        op.launches += 1
    return len(chunks)


def require_rows(t, op: str, name: str = "x", ndim: int = 2,
                 dtype=None) -> None:
    """Raise unless t is rows op's kernel entry takes: on a CUDA device,
    of ndim axes, at least one row along the first, then ``require``'s
    contiguous tensor of `dtype` (float32 when None)."""
    if t.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {t.device}")
    if t.ndim != ndim:
        raise ValueError(f"{op} expects {name} of {ndim} axes, channels "
                         f"first, got shape {tuple(t.shape)}")
    if t.shape[0] < 1:
        raise ValueError(f"{op}: channels must be positive, got 0")
    require(t, name, t.device, dtype=dtype)


def require(t, name: str, device, shape=None, dtype=None) -> None:
    """Raise unless tensor t is a contiguous tensor on `device` of `dtype`
    (float32 when None) and of `shape`: what every kernel entry takes."""
    import torch
    dtype = torch.float32 if dtype is None else dtype
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
