"""Plain float64 reference of the ``fir_lowpass_1024`` configuration: the
upstream's FIR (vv-dsp ``src/filter/fir.c``), ``vv_dsp_fir_design_lowpass``
then ``vv_dsp_fir_apply``, which is ``scipy.signal.lfilter(h, [1], x)``
(the upstream's ``python/test_filters.py``). Imports numpy, torch and the
reference's own ``common`` only.

``call`` designs the Hamming-windowed sinc lowpass again from the fields
(``common.lowpass``) and filters each row causally from zero history
(``common.causal_fir``, zero-padded float64 FFTs), cut to the row's
length. The upstream filters one channel; the configuration filters rows
in a batch, each on its own.
"""

from __future__ import annotations

import torch

from h100bench.reference import common as C

# err_of_scale: max |got - want| / max |want| over every sample of an
# answer. On an H100 the program read 1.882e-6 to 2.239e-6 over 24 seeds
# and the control 5.134e-6 to 6.815e-6 over 6, so the limit sits 1.52x
# above the one and 1.51x below the other, their geometric mean: the two
# tiers' errors lie that close, and no wider room holds both (PERF.md).
LIMITS = {"call": {"err_of_scale": 3.4e-6}}

# The configuration states the f32 tier (float32 accuracy: six bf16
# products a multiply-add); the control is the program's own tier below
# it, bf16x3 (three products, the low parts' product and the third parts
# dropped).
CONTROL = {"call": {"kind": "program", "fields": {"algorithm": "bf16x3"}}}


def taps(fields: dict):
    """The configuration's taps, float64 numpy: 2 fc sinc(2 fc m) times
    the Hamming window (the only window ``common.lowpass`` designs)."""
    if fields["window"] != "hamming":
        raise ValueError("the reference designs Hamming lowpass taps only, "
                         f"not {fields['window']!r}")
    return C.lowpass(fields["fir_taps"], fields["fir_cutoff"])


def call(fields: dict, x: torch.Tensor) -> torch.Tensor:
    """(c, n) rows -> (c, n) float64, lfilter(h, [1], x)."""
    return C.causal_fir(x.double(), taps(fields))
