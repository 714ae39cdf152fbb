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

TF32 is pinned off when this module is imported: PyTorch runs float32
convolutions through cuDNN in TF32 by default, which keeps about three
decimal digits, and every plain path here is held to float32 tolerances.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_REAL_DTYPE = torch.float32
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


def dot_algorithm(algorithm: str | None = None) -> str:
    """Resolve a dot-algorithm name: an explicit tier, or None -> "f32",
    what the JAX package resolves None to under its default matmul
    precision."""
    if algorithm is None:
        return "f32"
    if algorithm not in ALGORITHMS:
        raise ValueError("algorithm must be f32 | bf16x3 | bf16")
    return algorithm


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def tier_matmul(a: torch.Tensor, b: torch.Tensor,
                algorithm: str) -> torch.Tensor:
    """a @ b at a dot-algorithm tier, for float32 operands: bf16x3 splits
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
