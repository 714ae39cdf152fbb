"""Carry the JAX reference's parameters across to the port.

The JAX models' state is host constants: the chain's float32 FIR taps and
the numpy arrays the kernels are built from. ``params_from_reference``,
``gate_params_from_reference``, ``frontend_params_from_reference`` and
``streaming_params_from_reference`` take those arrays (the caller reads
them from the JAX package; this package does not import it) and return
the ``params`` of ``NorthStarChain``, ``SpectralGate``, ``MFCCFrontend``
and ``StreamingNorthStar``, so that a port model built from them computes
the same function as the JAX model; ``stream_state_from_reference``
carries a stream's state across, so that it resumes here:

    ref = vv_dsp_tpu.models.NorthStarChain()
    g, offset = vv_dsp_tpu.ops.resample._fused_fir_resample_filter(
        tuple(ref.fir_coeffs.astype("float64")), 4, 3)
    params = params_from_reference(ref.fir_coeffs, window, g, offset,
                                   mel_fb, dct_lift)
    chain = NorthStarChain(params=params)
"""

from __future__ import annotations

import numpy as np
import torch

from vv_dsp_tpu_torch.utils.device import build_device


def params_from_reference(fir_coeffs, window, g, offset: int, mel_fb,
                          dct_lift) -> dict:
    """numpy arrays of the reference chain -> NorthStarChain params.

    fir_coeffs: (taps,) FIR taps as the reference keeps them (float32);
    window: (nfft,) analysis window; g, offset: the composite head filter
    and its offset; mel_fb: (n_mels, nfft//2+1) filterbank; dct_lift:
    (n_mfcc, n_mels) DCT-II rows with the lifter folded in."""
    params = {
        "fir_coeffs": np.asarray(fir_coeffs),
        "window": np.asarray(window, dtype=np.float64),
        "g": np.asarray(g, dtype=np.float64),
        "offset": int(offset),
        "mel_fb": np.asarray(mel_fb, dtype=np.float64),
        "dct_lift": np.asarray(dct_lift, dtype=np.float64),
    }
    for name in ("fir_coeffs", "window", "g"):
        if params[name].ndim != 1:
            raise ValueError(f"{name} must be 1-D")
    if params["mel_fb"].shape[1] != len(params["window"]) // 2 + 1:
        raise ValueError("mel_fb must have nfft//2+1 columns")
    if params["dct_lift"].shape[1] != params["mel_fb"].shape[0]:
        raise ValueError("dct_lift must have n_mels columns")
    return params


def gate_params_from_reference(window) -> dict:
    """The reference SpectralGate's window (its ``stft_plan.win``, or the
    float64 ``get_window_np`` values) -> SpectralGate params."""
    window = np.asarray(window, dtype=np.float64)
    if window.ndim != 1:
        raise ValueError("window must be 1-D")
    return {"window": window}


def frontend_params_from_reference(window, mel_fb, dct_lift) -> dict:
    """numpy arrays of the reference MFCCFrontend -> MFCCFrontend params.

    window: (nfft,) analysis window; mel_fb: (n_mels, nfft//2+1)
    filterbank (``mel_filterbank_np``); dct_lift: (n_mfcc, n_mels) DCT-II
    rows with the lifter folded in."""
    params = {"window": np.asarray(window, dtype=np.float64),
              "mel_fb": np.asarray(mel_fb, dtype=np.float64),
              "dct_lift": np.asarray(dct_lift, dtype=np.float64)}
    if params["window"].ndim != 1:
        raise ValueError("window must be 1-D")
    if params["mel_fb"].shape[1] != len(params["window"]) // 2 + 1:
        raise ValueError("mel_fb must have nfft//2+1 columns")
    if params["dct_lift"].shape[1] != params["mel_fb"].shape[0]:
        raise ValueError("dct_lift must have n_mels columns")
    return params


def streaming_params_from_reference(fir_coeffs) -> dict:
    """The reference StreamingNorthStar's ``fir_coeffs`` (float32, as it
    keeps them) -> StreamingNorthStar params."""
    fir_coeffs = np.asarray(fir_coeffs)
    if fir_coeffs.ndim != 1:
        raise ValueError("fir_coeffs must be 1-D")
    return {"fir_coeffs": fir_coeffs}


def stream_state_from_reference(state, device="cuda"):
    """A reference stream state (a tree of numpy arrays in dicts, lists and
    tuples, e.g. ``np.asarray`` of each leaf of a JAX StreamingNorthStar
    state) -> the same tree of tensors on `device`, so that a stream begun
    in the reference resumes here. Raises without a GPU for "cuda"."""
    device = build_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {key: convert(value) for key, value in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(value) for value in node)
        return torch.tensor(np.asarray(node), device=device)

    return convert(state)
