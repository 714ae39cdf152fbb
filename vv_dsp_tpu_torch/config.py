"""Dtype and precision policy of the PyTorch port (counterpart of
``vv_dsp_tpu/config.py``).

- Signals compute in float32; integer PCM and sub-single floats are
  promoted at op entry (``as_compute``).
- Constants (windows, filters, filterbanks, DCT rows, twiddles) are built on
  the host in numpy float64 and cast once.
- Contractions that trade accuracy for speed name a dot-algorithm tier,
  ``"f32" | "bf16x3" | "bf16"``, with the meanings of
  ``vv_dsp_tpu/ops/pallas_kernels.py::dot_alg``. The CUDA-core kernels
  implement the tiers product by product (``csrc/common.cuh``), the
  tensor-core kernels as sums of bf16 products of the operands' parts
  (``csrc/mma_tiers.cuh``); their plain versions use ``tier_matmul``.

The matmul-precision knob (``set_matmul_precision``, "highest" by
default) names the tier a contraction takes when its caller names none:
highest -> "f32", high -> "bf16x3", default -> "bf16", as the JAX
package's ``pallas_kernels.dot_algorithm`` maps it.

TF32 is pinned off when this module is imported: PyTorch runs float32
convolutions through cuDNN in TF32 by default, which keeps about three
decimal digits, and every plain path here is held to float32 tolerances.
"""

from __future__ import annotations

import contextlib
import sys

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_REAL_DTYPE = torch.float32
DEFAULT_COMPLEX_DTYPE = torch.complex64
# the kernels' tier codes are indices into this tuple (csrc/common.cuh)
ALGORITHMS = ("f32", "bf16x3", "bf16")


def real_dtype(dtype=None) -> torch.dtype:
    """Resolve a real dtype argument (None -> default)."""
    return DEFAULT_REAL_DTYPE if dtype is None else dtype


def as_compute(x: torch.Tensor) -> torch.Tensor:
    """Promote a signal to its compute dtype at op entry: integers (PCM
    buffers) and sub-single floats (bf16/f16) become float32; float32,
    float64 and complex pass through untouched."""
    if x.is_complex():
        return x
    if x.is_floating_point():
        return x if torch.finfo(x.dtype).bits >= 32 else x.float()
    return x.float()


# the knob's names and the tier each resolves None to
_PRECISIONS = {"highest": "f32", "high": "bf16x3", "default": "bf16"}
MATMUL_PRECISION = "highest"


def set_matmul_precision(name: str) -> None:
    """Runtime accuracy/throughput knob for every contraction whose caller
    names no tier: "highest" (f32), "high" (bf16x3) or "default" (bf16).
    It takes effect on the next call; the port caches no compiled
    program."""
    global MATMUL_PRECISION
    if name not in _PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}")
    MATMUL_PRECISION = name


def get_matmul_precision() -> str:
    return MATMUL_PRECISION


@contextlib.contextmanager
def matmul_precision(name: str):
    """Scoped ``set_matmul_precision``: the knob holds for every call made
    inside the block, and the previous setting returns after it."""
    global MATMUL_PRECISION
    prev = MATMUL_PRECISION
    set_matmul_precision(name)
    try:
        yield
    finally:
        MATMUL_PRECISION = prev


def dot_algorithm(algorithm: str | None = None) -> str:
    """Resolve a dot-algorithm name: an explicit tier, or None -> the
    knob's tier (``set_matmul_precision``)."""
    if algorithm is None:
        return _PRECISIONS[MATMUL_PRECISION]
    if algorithm not in ALGORITHMS:
        raise ValueError("algorithm must be f32 | bf16x3 | bf16")
    return algorithm


def complex_dtype(dtype=None) -> torch.dtype:
    """Resolve a complex dtype argument (None -> default)."""
    return DEFAULT_COMPLEX_DTYPE if dtype is None else dtype


def complex_for_real(dtype) -> torch.dtype:
    """Matching complex dtype for a real dtype."""
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def clear_all_caches(include_jit: bool = False) -> int:
    """Clear every ``functools.lru_cache`` of the loaded vv_dsp_tpu_torch
    modules (windows, filterbanks, DFT bases, polyphase tables, OLA norms,
    plans, device constants); returns how many were cleared.
    include_jit: accepted for the JAX signature; the port keeps no cache
    of compiled programs (the kernels are one library, built once), so
    there is nothing more to drop."""
    cleared = 0
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == "vv_dsp_tpu_torch"
                               or name.startswith("vv_dsp_tpu_torch.")):
            continue
        for attr in list(vars(mod).values()):
            if (callable(getattr(attr, "cache_clear", None))
                    and hasattr(attr, "cache_info")):
                attr.cache_clear()
                cleared += 1
    return cleared


_flush_denormals = False


def _kernels_flush_denormals() -> bool:
    """Whether the kernels are compiled to flush denormals (nvcc -ftz):
    a property of the build flags, not switchable at run time."""
    from vv_dsp_tpu_torch import _build
    flags = " ".join(_build.NVCC_FLAGS)
    return "-ftz=true" in flags or "--use_fast_math" in flags


def set_flush_denormals(enabled: bool, device="cuda") -> bool:
    """Denormal flushing (the reference's vv_dsp_set_flush_denormals,
    src/core/fp_env.c). Sets PyTorch's CPU flag
    (``torch.set_flush_denormal``) and returns the effective state on
    `device`: on the CPU whether flushing is on (False where the CPU cannot
    flush), on the card what the kernels were compiled with, which no
    call changes."""
    global _flush_denormals
    supported = torch.set_flush_denormal(bool(enabled))
    _flush_denormals = bool(enabled) and supported
    return get_flush_denormals(device)


def get_flush_denormals(device="cuda") -> bool:
    """The effective denormal flushing on `device` (see
    ``set_flush_denormals``)."""
    if torch.device(device).type == "cuda":
        return _kernels_flush_denormals()
    return _flush_denormals


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def tier_matmul(a: torch.Tensor, b: torch.Tensor,
                algorithm: str | None) -> torch.Tensor:
    """a @ b at a dot-algorithm tier (None: the knob's), for float32
    operands: bf16x3 splits
    both operands into bf16 hi/lo parts and sums hi@hi + hi@lo + lo@hi in
    float32; bf16 multiplies the bf16 roundings once. A product of two bf16
    values is exact in float32, so a float32 matmul of the rounded values
    gives the tier's numbers."""
    algorithm = dot_algorithm(algorithm)
    if algorithm == "f32":
        return a @ b
    if algorithm == "bf16":
        return _bf16(a) @ _bf16(b)
    a_hi, b_hi = _bf16(a), _bf16(b)
    a_lo, b_lo = _bf16(a - a_hi), _bf16(b - b_hi)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
