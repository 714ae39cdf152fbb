"""The spectrum handed from ``STFT.process_packed`` to
``STFT.reconstruct_packed`` (counterpart of
``vv_dsp_tpu/ops/pallas_fft.py::PackedSpectrum``).

The JAX package keeps it in its TPU kernels' storage layout (bins in a
bit-reversed row order, frames on lanes) so that a roundtrip skips two
relayout passes. On the card the forward kernel writes the one-sided
spectrum in natural order and the inverse kernel reads it as written, so
the storage here is that tensor: complex64 (channels, frames, nfft//2+1).
Edits are differentiable: the forward and inverse go through their
kernels' gradient shims, and ``apply_mask`` is a plain product.
"""

from __future__ import annotations

import numpy as np
import torch


class PackedSpectrum:
    """One-sided windowed STFT spectrum ``spec`` (channels, frames,
    nfft//2+1), natural bin order, with its geometry."""

    def __init__(self, spec: torch.Tensor, nfft: int, hop: int):
        if spec.shape[-1] != nfft // 2 + 1:
            raise ValueError(f"spec must have {nfft // 2 + 1} one-sided bins")
        self.spec = spec
        self.nfft = nfft
        self.hop = hop

    @property
    def nf(self) -> int:
        return self.spec.shape[-2]

    @property
    def power_rows(self) -> torch.Tensor:
        """|X|^2 in storage order, which here is natural bin order."""
        return self.spec.real * self.spec.real + self.spec.imag * self.spec.imag

    def bin_to_row(self) -> np.ndarray:
        """Storage row of each natural bin 0..nfft//2: the identity, since
        the storage is in natural order."""
        return np.arange(self.nfft // 2 + 1)

    def apply_mask(self, mask_natural) -> "PackedSpectrum":
        """Multiply by a per-bin mask in natural one-sided bin order
        (nfft//2+1 values; a tensor keeps its gradient)."""
        m = self.nfft // 2
        mask = torch.as_tensor(mask_natural, dtype=torch.float32,
                               device=self.spec.device)
        if mask.shape[-1] != m + 1:
            raise ValueError(f"mask must have {m + 1} one-sided bins")
        return PackedSpectrum(self.spec * mask, self.nfft, self.hop)

    def to_natural(self, onesided: bool = True) -> torch.Tensor:
        """The complex spectrum (channels, frames, bins): one-sided, or all
        nfft bins with the Hermitian mirror X[nfft-k] = conj X[k]."""
        if onesided:
            return self.spec
        mirror = self.spec[..., 1:self.nfft // 2].flip(-1).conj()
        return torch.cat([self.spec, mirror], dim=-1)
