"""The overlap-save FIR kernel (``csrc/fir_os.cu fir_os_kernel``) on the CPU:
its plain version ``fir_os_plain`` and its float64 replay against float64
``scipy.signal.lfilter``, its table and its segment geometry.

The kernel, replayed with its own index maps: segment b of a row reads the
4,096 samples from b * block - lead (zero outside the row) as M = 2,048
packed points, thread j holding p = j + s M/8 (s < 8); the forward passes
of ``csrc/fft_reg.cuh`` (``torch_fft_replay.replay_fft``); for its eight
bins k, conj Z'[k] from Z[k], Z[(M - k) mod M] and the table's float4; the
same passes on that; the outputs b * block + i, i < block, read from point
lead/2 + i div 2 (Re for even i, -Im for odd), cut at n.

Tolerances, of max |y| from n = taps on: the float64 replay 1e-12, the
float32 plain version 1e-6. Below that the outputs are the
filter's first taps alone, which in a windowed lowpass are 1e-4 of its
peak, while any FFT convolution's rounding follows the whole filter's
gain: there the error is held to the same fractions of the largest output
the filter can give on the input, sum |h| max |x| (the plain version here
reads up to 3.5e-4 of max |y| at n = 1, 8e-9 of the gain).
"""

import numpy as np
import pytest
import torch
from scipy import signal as ss

from torch_fft_replay import replay_fft
from vv_dsp_tpu_torch.ops import filter_kernels as tfk
from vv_dsp_tpu_torch.ops.fir import design_lowpass_np, fir_apply_os

M = tfk.OS_NFFT // 2
PLAIN_TOL = 1e-6
EXACT_TOL = 1e-12
CELL_N = 479232          # the fir1024.batch64 cell's rows


def _lengths(taps):
    """n = 1, n < block, block k +- 1 and the first n past lead."""
    block = tfk.os_geometry(taps)[1]
    return (1, 100, taps - 1, block - 1, block, block + 1, 3 * block - 1,
            3 * block + 1)


def _scale(h, x, want):
    """max |y|, or below n = taps the filter's gain on x (docstring)."""
    if x.shape[-1] < len(h):
        return np.abs(h).sum() * np.abs(x).max()
    return np.abs(want).max()


def replay_fir_os(x, h):
    """fir_os_kernel on rows x (float64), with a float64 table."""
    taps = len(h)
    lead, block = tfk.os_geometry(taps)
    tab = tfk.os_table_np(h, np.float64)
    ca, cb = tab[:, 0] + 1j * tab[:, 1], tab[:, 2] + 1j * tab[:, 3]
    c, n = x.shape
    y = np.full((c, n), np.nan)
    k = np.arange(M)
    for r in range(c):
        for b in range(-(-n // block)):
            s0 = b * block - lead
            i = s0 + np.arange(tfk.OS_NFFT)
            seg = np.where((i >= 0) & (i < n), x[r, np.clip(i, 0, n - 1)], 0)
            z = replay_fft(seg[0::2] + 1j * seg[1::2], M)
            v = ca * np.conj(z) + cb * z[(M - k) & (M - 1)]
            w = replay_fft(v, M)
            count = min(block, n - b * block)
            o = np.arange(count)
            u = w[lead // 2 + (o >> 1)]
            y[r, b * block + o] = np.where(o & 1, -u.imag, u.real)
    return y


@pytest.mark.parametrize("taps", [512, 1024, 2048])
def test_geometry_covers_the_wrap(taps):
    lead, block = tfk.os_geometry(taps)
    assert lead >= taps - 1 and lead % 2 == 0 and block % 2 == 0
    assert lead + block == tfk.OS_NFFT
    assert tfk.os_geometry(1024) == (1024, 3072)


def test_geometry_refuses_taps_past_the_kernel():
    for taps in (0, tfk.KERNEL_MAX_TAPS + 1):
        with pytest.raises(ValueError):
            tfk.os_geometry(taps)


@pytest.mark.parametrize("taps", [512, 513, 2048])
def test_replay_matches_lfilter(rng, taps):
    h = design_lowpass_np(taps, 0.45)
    block = tfk.os_geometry(taps)[1]
    for n in (1, block - 1, 2 * block + 1):
        x = rng.standard_normal((2, n))
        got = replay_fir_os(x, h)
        want = ss.lfilter(h, [1.0], x, axis=-1)
        assert not np.isnan(got).any()
        assert np.abs(got - want).max() < EXACT_TOL * _scale(h, x, want)


@pytest.mark.parametrize("taps", [512, 1024, 2048])
def test_plain_matches_lfilter(rng, taps):
    h = design_lowpass_np(taps, 0.45)
    table = torch.as_tensor(tfk.os_table_np(h))
    for n in _lengths(taps):
        x = rng.standard_normal((3, n))
        got = tfk.fir_os_plain(torch.as_tensor(x, dtype=torch.float32),
                               table, taps).double().numpy()
        want = ss.lfilter(h, [1.0], x, axis=-1)
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err < PLAIN_TOL * _scale(h, x, want), (taps, n)


def test_plain_matches_lfilter_at_the_cell_length(rng):
    h = design_lowpass_np(1024, 0.45)
    x = rng.standard_normal((2, CELL_N))
    got = tfk.fir_os_plain(torch.as_tensor(x, dtype=torch.float32),
                           torch.as_tensor(tfk.os_table_np(h)), 1024)
    want = ss.lfilter(h, [1.0], x, axis=-1)
    err = np.abs(got.double().numpy() - want).max()
    assert err < PLAIN_TOL * np.abs(want).max()


def test_plain_is_fir_apply_os_at_the_kernel_block(rng):
    """The same function as fir.fir_apply_os at block 3,073, its segments
    one sample off: float32 rounding apart."""
    h = design_lowpass_np(1024, 0.45)
    x = torch.as_tensor(rng.standard_normal((2, 20000)), dtype=torch.float32)
    got = tfk.fir_os_plain(x, torch.as_tensor(tfk.os_table_np(h)), 1024)
    want = fir_apply_os(h, x, 3073)
    assert (got - want).abs().max() < PLAIN_TOL * want.abs().max()


def test_plain_keeps_leading_axes(rng):
    h = design_lowpass_np(600, 0.3)
    table = torch.as_tensor(tfk.os_table_np(h))
    x = torch.as_tensor(rng.standard_normal((2, 3, 5000)),
                        dtype=torch.float32)
    got = tfk.fir_os_plain(x, table, 600)
    assert got.shape == x.shape
    flat = tfk.fir_os_plain(x.reshape(6, 5000), table, 600)
    assert (got.reshape(6, 5000) - flat).abs().max() < 1e-6


def test_fir_os_on_a_cpu_tensor_takes_the_plain_version():
    """The wrapper's range is os_geometry's; a CPU tensor takes the plain
    version and launches nothing."""
    x = torch.zeros((1, 10))
    table = torch.as_tensor(tfk.os_table_np(np.ones(4)))
    before = tfk.fir_os.launches
    assert torch.equal(tfk.fir_os(x, table, 4), tfk.fir_os_plain(x, table, 4))
    assert tfk.fir_os.launches == before
    with pytest.raises(ValueError):
        tfk.fir_os(x, table, tfk.KERNEL_MAX_TAPS + 1)
