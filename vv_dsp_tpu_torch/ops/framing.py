"""Signal framing (counterpart of ``vv_dsp_tpu/ops/framing.py``, the part
the STFT uses).

Non-centered framing: frame f starts at f*hop and the tail frame is
zero-padded. The frame count of the STFT (``stft_num_frames``) is
``1 if n < nfft else 1 + (n - nfft + hop) // hop``, which may include a
frame that runs past the signal.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stft_num_frames(n: int, nfft: int, hop: int) -> int:
    """Frame count used by the STFT (vv_dsp_tpu/ops/stft.py::num_frames)."""
    if n < nfft:
        return 1
    return 1 + (n - nfft + hop) // hop


def frames_strided(signal: torch.Tensor, frame_len: int, hop_len: int,
                   n_frames: int) -> torch.Tensor:
    """(..., n) -> (..., n_frames, frame_len): frame f is
    signal[..., f*hop : f*hop + frame_len], zero past the end. The frames
    are a strided view of the zero-padded signal; nothing is gathered."""
    n = signal.shape[-1]
    need = (n_frames - 1) * hop_len + frame_len
    if need > n:
        signal = F.pad(signal, (0, need - n))
    return signal[..., :need].unfold(-1, frame_len, hop_len)
