"""The device that a model's buffers or a stream's state are built on."""

from __future__ import annotations

import torch


def build_device(device) -> torch.device:
    """`device` as a torch.device; "cuda" raises without a GPU rather than
    building on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to build on "
                           "the CPU")
    return device
