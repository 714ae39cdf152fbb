"""Signal framing and overlap-add (counterpart of
``vv_dsp_tpu/ops/framing.py``, the part the STFT and its inverse use).

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


def overlap_add_strided(frames: torch.Tensor, hop_len: int,
                        output_len: int) -> torch.Tensor:
    """(..., n_frames, frame_len) -> (..., output_len) by frame_len/hop
    shifted dense adds (requires frame_len % hop == 0); the same result as
    ``overlap_add``: samples past output_len are dropped, and a shorter
    cover is zero-padded to output_len."""
    n_frames, frame_len = frames.shape[-2], frames.shape[-1]
    if frame_len % hop_len:
        raise ValueError("overlap_add_strided requires frame_len % hop == 0")
    total = (n_frames - 1) * hop_len + frame_len
    out = frames.new_zeros(frames.shape[:-2] + (total,))
    for j in range(frame_len // hop_len):
        part = frames[..., j * hop_len:(j + 1) * hop_len]
        out[..., j * hop_len:j * hop_len + n_frames * hop_len] += part.reshape(
            frames.shape[:-2] + (n_frames * hop_len,))
    if total >= output_len:
        return out[..., :output_len]
    return F.pad(out, (0, output_len - total))


def overlap_add(frames: torch.Tensor, hop_len: int,
                output_len: int) -> torch.Tensor:
    """Scatter-add frames back onto a time axis: (..., n_frames, frame_len)
    -> (..., output_len). Samples falling past output_len are dropped
    (bounds clipping, as the reference's vv_dsp_overlap_add)."""
    n_frames, frame_len = frames.shape[-2], frames.shape[-1]
    idx = (torch.arange(n_frames, device=frames.device)[:, None] * hop_len
           + torch.arange(frame_len, device=frames.device)[None, :])
    # out-of-range samples go to a trash slot past the end
    idx = torch.where(idx >= output_len, output_len, idx).reshape(-1)
    out = frames.new_zeros(frames.shape[:-2] + (output_len + 1,))
    out.index_add_(-1, idx, frames.reshape(frames.shape[:-2] + (-1,)))
    return out[..., :output_len]
