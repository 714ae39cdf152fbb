"""What the per-phase polyphase kernel's memory walk costs without its sums,
on one NVIDIA GPU.

    python -m vv_dsp_tpu_torch.tools.poly_floor

Builds three variants of ``csrc/filter.cu``'s poly_kernel from this
checkout's source, the same flags and the same host plan
(``ops/poly_plan.py``): the kernel as it is; its sums left out (the
window copies, both barriers and the output stores: the walk's memory
floor); and its sums and stores left out (the copies alone). Each runs at
4/3, 2/1, 1/2, 3/4 and 7/5 on (16, 479232 cut to a multiple of down),
N(0, 1) from seed 0, and prints its device time under torch.profiler (the
mean of the kernel events of 20 calls) beside the call's byte bound and the rate the bytes moved at. The
variants are built into ``build/vv_dsp_tpu_torch/poly_floor/`` and used
nowhere else.
"""

from __future__ import annotations

import ctypes
import math
import subprocess

import numpy as np
import torch

from vv_dsp_tpu_torch import _build
from vv_dsp_tpu_torch.ops import poly_plan as pp

RATIOS = ((4, 3), (2, 1), (1, 2), (3, 4), (7, 5))
HBM_BYTES_PER_S = 3.35e12
# the lines each variant's switch guards in csrc/filter.cu
SUMS = "for (int item = warp; item < items; item += warps) {"
STORES = "if (f_out < g_out) {"


def variant_source(sums: bool, stores: bool) -> str:
    src = (_build.SRC_DIR / "filter.cu").read_text()
    for line, keep in ((SUMS, sums), (STORES, stores)):
        if src.count(line) != 1:
            raise RuntimeError(f"poly_floor: {line!r} not found once in "
                               f"csrc/filter.cu")
        if not keep:
            src = src.replace(line, line.replace("(", "(false && ", 1)
                              if line.startswith("if") else
                              line.replace("item < items", "item < 0"))
    return src


def build(name: str, src: str) -> ctypes.CDLL:
    out = _build.BUILD_ROOT / "poly_floor"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    "-I", str(_build.SRC_DIR), "-o", str(lib), str(cu)],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.vv_poly.argtypes = _build.POLY_ARGTYPES
    dll.vv_poly.restype = ctypes.c_int
    return dll


def device_ms(fn, calls: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # over the events the trace holds, which may miss some of the calls
    ev = [e for e in prof.key_averages() if "poly_kernel" in e.key]
    n = sum(e.count for e in ev)
    return sum(e.device_time_total for e in ev) / 1e3 / n if n else math.nan


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("poly_floor: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    libs = {"kernel": build("kernel", variant_source(True, True)),
            "no sums": build("no_sums", variant_source(False, True)),
            "copies only": build("copies", variant_source(False, False))}
    dev = torch.device("cuda", 0)
    x = np.random.default_rng(0).standard_normal((16, 479232))
    for up, down in RATIOS:
        xv = torch.as_tensor(x[:, :x.shape[1] // down * down],
                             dtype=torch.float32, device=dev)
        c, n_in = xv.shape
        n_out = -(-n_in * up // down)
        y = torch.empty((c, n_out), dtype=torch.float32, device=dev)
        p = pp.poly_plan(up, down)
        w, o = pp.poly_tables(up, down, dev)
        nbytes = 4 * (xv.numel() + y.numel() + up * p.taps_pp)
        row = []
        for name, lib in libs.items():
            def call():
                err = lib.vv_poly(
                    _build.ptr(xv), _build.ptr(w), _build.ptr(o),
                    _build.ptr(y), c, n_in, n_out, up, down, p.ncls,
                    p.n_big, p.k, p.lo, p.row_len, p.q_pitch, p.p_pitch,
                    p.frames, p.threads, p.smem, 0, _build.stream_handle(xv))
                if err:
                    raise RuntimeError(f"poly_floor {name}: CUDA error {err}")
            ms = device_ms(call)
            row.append(f"{name} {ms:.4f} ms ({nbytes / ms / 1e9:.2f} TB/s)")
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"poly_floor {up}/{down} {tuple(xv.shape)}, bound {bound:.4f} "
              f"ms: " + "; ".join(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
