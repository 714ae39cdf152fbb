"""NaN/Inf handling policy as an explicit argument (counterpart of
``vv_dsp_tpu/utils/nan_policy.py``; the reference's global policy,
src/core/nan_policy.c:33-190, applied by the DCT and Savitzky-Golay to
their inputs and outputs).

PROPAGATE (default): identity. IGNORE: NaN/Inf -> 0. CLAMP: NaN -> 0,
+Inf -> +max finite, -Inf -> -max finite. ERROR: identity, as in the JAX
package: the non-finite values propagate, and the caller checks
``has_nan_or_inf``.
"""

from __future__ import annotations

import enum

import torch


class NanPolicy(enum.Enum):
    PROPAGATE = "propagate"
    IGNORE = "ignore"
    ERROR = "error"
    CLAMP = "clamp"


def has_nan_or_inf(x: torch.Tensor) -> torch.Tensor:
    """Scalar bool tensor: any non-finite element (vv_dsp_has_nan_inf)."""
    return (~torch.isfinite(x)).any()


def apply_nan_policy(x: torch.Tensor,
                     policy: NanPolicy = NanPolicy.PROPAGATE) -> torch.Tensor:
    """Apply the NaN/Inf policy elementwise."""
    if policy in (NanPolicy.PROPAGATE, NanPolicy.ERROR):
        return x
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if policy == NanPolicy.IGNORE:
        return torch.where(torch.isfinite(x), x, zero)
    if policy == NanPolicy.CLAMP:
        big = torch.finfo(x.dtype).max
        return torch.nan_to_num(x, nan=0.0, posinf=big, neginf=-big)
    raise ValueError(f"unknown NaN policy: {policy!r}")
