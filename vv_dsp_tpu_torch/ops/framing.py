"""Signal framing and overlap-add (counterpart of
``vv_dsp_tpu/ops/framing.py``).

Boundary semantics of the reference (src/core/framing.c):
- centered framing: frame f is centered at f*hop, with symmetric
  reflection at both ends (idx = -1 -> x[0], idx = n -> x[n-1]: numpy's
  'symmetric' pad mode);
- non-centered framing: frame f starts at f*hop, zero-padded past the end;
- ``num_frames``: centered ceil(n / hop), non-centered
  1 + (n - frame) // hop (0 when n < frame).

The STFT's own frame count (``stft_num_frames``) is
``1 if n < nfft else 1 + (n - nfft + hop) // hop``, which may include a
frame that runs past the signal.

Every overlap-add here is a sum of shifted dense adds: deterministic on a
CUDA tensor (a scatter-add is not) and differentiable without a scatter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def num_frames(signal_len: int, frame_len: int, hop_len: int,
               center: bool) -> int:
    """Frame count (vv_dsp_get_num_frames, src/core/framing.c:58-69)."""
    if hop_len <= 0:
        return 0
    if center:
        return -(-signal_len // hop_len)
    if signal_len < frame_len:
        return 0
    return 1 + (signal_len - frame_len) // hop_len


def stft_num_frames(n: int, nfft: int, hop: int) -> int:
    """Frame count used by the STFT (vv_dsp_tpu/ops/stft.py::num_frames)."""
    if n < nfft:
        return 1
    return 1 + (n - nfft + hop) // hop


def symmetric_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Map integer indices into [0, n) by symmetric reflection
    (..., x1, x0 | x0, x1, ..., x_{n-1} | x_{n-1}, ...), the reference's
    reflect_index (src/core/framing.c:21-56)."""
    if n == 1:
        return torch.zeros_like(idx)
    m = torch.remainder(idx, 2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def frame_indices(signal_len: int, frame_len: int, hop_len: int,
                  center: bool, n_frames: int | None = None, device="cuda"):
    """((n_frames, frame_len) int64 gather indices, validity mask) on
    `device`. Centered: indices reflected into range, mask None.
    Non-centered: out-of-range taps clamped to 0..n-1 and masked False."""
    if n_frames is None:
        n_frames = num_frames(signal_len, frame_len, hop_len, center)
    starts = torch.arange(n_frames, device=device) * hop_len
    if center:
        starts = starts - frame_len // 2
    idx = starts[:, None] + torch.arange(frame_len, device=device)[None, :]
    if center:
        return symmetric_index(idx, signal_len), None
    mask = (idx >= 0) & (idx < signal_len)
    return idx.clamp(0, max(signal_len - 1, 0)), mask


def fetch_frames(signal: torch.Tensor, frame_len: int, hop_len: int,
                 center: bool = True, window=None) -> torch.Tensor:
    """(..., n) -> (..., num_frames, frame_len), each frame times `window`
    when given (vv_dsp_fetch_frame's window argument)."""
    n = signal.shape[-1]
    idx, mask = frame_indices(n, frame_len, hop_len, center,
                              device=signal.device)
    frames = signal[..., idx]
    if mask is not None:
        frames = torch.where(mask, frames, torch.zeros((), dtype=frames.dtype,
                                                       device=frames.device))
    if window is not None:
        frames = frames * torch.as_tensor(window, dtype=frames.dtype,
                                          device=frames.device)
    return frames


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
    """Add frames back onto a time axis at f*hop: (..., n_frames,
    frame_len) -> (..., output_len). Samples falling past output_len are
    dropped (bounds clipping, as the reference's vv_dsp_overlap_add). Any
    hop: the frames are zero-padded to ceil(frame_len/hop) whole hops and
    added as ``overlap_add_strided`` adds them."""
    frame_len = frames.shape[-1]
    padded = -(-frame_len // hop_len) * hop_len
    if padded != frame_len:
        frames = F.pad(frames, (0, padded - frame_len))
    return overlap_add_strided(frames, hop_len, output_len)
