"""Leading-axes collapse for 2-D kernels (counterpart of
``vv_dsp_tpu/utils/shapes.py``): 1-D signals and (batch, channels, time)
tensors fold their leading axes into one channel axis, run the (channels,
time) kernel, and unfold."""

from __future__ import annotations


def collapse_leading(x):
    """(..., t) -> ((-1, t) view, restore) where restore(out, out_trailing)
    maps a kernel output whose last `out_trailing` axes are new (e.g. 1 for
    sample streams, 2 for (frames, bins)) back to the original leading
    shape.  Works for 1-D (adds a singleton channel) through N-D."""
    lead = x.shape[:-1]
    x2 = x.reshape((-1, x.shape[-1]))

    def restore(out, out_trailing: int = 1):
        return out.reshape(tuple(lead) + tuple(out.shape[-out_trailing:]))

    return x2, restore
