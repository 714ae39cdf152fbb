"""Complex helpers (counterpart of ``vv_dsp_tpu/ops/complex_ops.py``):
the reference's vv_dsp_cpx make/add/sub/mul/conj/abs/phase/from_polar
(src/core/core.c:10-44) on complex tensors, and the host <-> device moves
of complex data. PyTorch moves complex tensors as they are, so those two
are ``tensor.to(device)`` and ``.cpu().numpy()``.
"""

from __future__ import annotations

import numpy as np
import torch


def cpx(re, im) -> torch.Tensor:
    """vv_dsp_cpx_make: a complex tensor from its parts (integer parts are
    promoted to float32)."""
    re, im = torch.as_tensor(re), torch.as_tensor(im)
    if not re.is_floating_point():
        re = re.float()
    return torch.complex(re, im.to(device=re.device, dtype=re.dtype))


def cpx_add(a, b):
    return a + b


def cpx_sub(a, b):
    return a - b


def cpx_mul(a, b):
    """vv_dsp_cpx_mul (src/core/core.c:19-23)."""
    return a * b


def cpx_conj(a: torch.Tensor) -> torch.Tensor:
    return torch.conj_physical(a)


def cpx_abs(a: torch.Tensor) -> torch.Tensor:
    """|a| via hypot (overflow-safe, as the reference's hypotf,
    src/core/core.c:28-30)."""
    return torch.hypot(a.real, a.imag)


def cpx_phase(a: torch.Tensor) -> torch.Tensor:
    """atan2(im, re) (src/core/core.c:32-34)."""
    return torch.atan2(a.imag, a.real)


def cpx_from_polar(mag, phase) -> torch.Tensor:
    """vv_dsp_cpx_from_polar (src/core/core.c:36-40)."""
    mag, phase = torch.as_tensor(mag), torch.as_tensor(phase)
    return cpx(mag * torch.cos(phase), mag * torch.sin(phase))


def cpx_to_device(x, device=None) -> torch.Tensor:
    """A host array (complex or real, numpy or tensor) as a tensor on
    `device`, the card unless the caller names another."""
    return torch.as_tensor(x).to(device or "cuda")


def cpx_from_device(x) -> np.ndarray:
    """A tensor on any device as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
