"""The roofline shares' arithmetic at the cells' shapes, and no share over
100%: neither when the card's measured times of the main path's kernels
(the port's kernel table, NVIDIA H100 80GB HBM3 at 700 W, 16 channels) are
put in the denominator, nor for a program whose stages overlap."""

from __future__ import annotations

import math

import pytest

from h100bench import peaks
from h100bench.manifest import Cell
from h100bench.reference import common


def _work(metric, cell, c=None, n=None):
    mod = cell.reader(metric)
    return mod.work_s(cell.fields, c or cell.channels(), n or cell.samples())


def _chain_units(c, n):
    """The chain's call at the cell's fields, by unit: bytes, tensor-core
    operations besides the FIR, float32 operations besides the FIR, the
    FIR's direct bf16x3 products and its overlap-save float32 operations."""
    n_out = n * 4 // 3
    frames = c * (1 + (n_out - 2048 + 512) // 512)
    nbytes = 4 * (c * n + frames * 20)
    nnz = int((common.mel_filterbank(2048, 80, 64000.0, 0.0, 32000.0)
               != 0).sum())
    tc = 2 * c * n_out * 81 / 4 * 3 + frames * (2 * nnz + 2 * 80 * 20) * 3
    f32 = frames * (2.5 * 2048 * 11 + 3 * 1025)
    # overlap-save at 8192 points: 7169 outputs a block
    fir_fft = c * n * (2 * 2.5 * 8192 * 13 + 6 * 4097) / 7169
    return nbytes, tc, f32, 2 * c * n * 1024 * 3, fir_fft


def test_chain_work_at_the_cell_shape():
    cell = Cell("chain.batch64")
    c, n = 64, 479232
    assert cell.samples() == n
    nbytes, tc, f32, fir_direct, fir_fft = _chain_units(c, n)
    direct = max(nbytes / 3.35e12, (tc + fir_direct) / 989e12, f32 / 67e12)
    fft = max(nbytes / 3.35e12, tc / 989e12, (f32 + fir_fft) / 67e12)
    # the FIR by FFTs at float32 gives the call less time than its direct
    # form on the tensor cores; both are bound by operations, not bytes
    assert fft < direct
    assert fft == pytest.approx((f32 + fir_fft) / 67e12)
    assert _work("roofline.chain", cell) == pytest.approx(fft, rel=1e-6)
    assert _work("roofline.chain", cell) * 1e3 == pytest.approx(0.106263,
                                                                rel=1e-4)


def test_fir_fft_flops_takes_the_best_block():
    per_sample = peaks.fir_fft_flops(1, 1, 1024)
    assert per_sample == pytest.approx((2 * 2.5 * 8192 * 13 + 6 * 4097)
                                       / 7169)
    for size in (2048, 4096, 16384, 32768):
        other = (2 * 2.5 * size * (size.bit_length() - 1)
                 + 6 * (size // 2 + 1)) / (size - 1023)
        assert per_sample <= other


@pytest.mark.parametrize("route", ["direct", "fft"])
def test_overlapped_stages_read_at_most_100(route):
    """A program whose stages overlap perfectly, each unit busy for its
    least time, takes as long as its busiest unit: it reads at most
    100%."""
    c, n = 64, 479232
    nbytes, tc, f32, fir_direct, fir_fft = _chain_units(c, n)
    if route == "direct":
        busy = max(nbytes / 3.35e12, (tc + fir_direct) / 989e12,
                   f32 / 67e12)
    else:
        busy = max(nbytes / 3.35e12, tc / 989e12, (f32 + fir_fft) / 67e12)
    cell = Cell("chain.batch64")
    rec = {"fields": cell.fields, "channels": c, "samples": n,
           "trace": {"busy_s": busy * 10, "calls": 10}}
    assert 0 < cell.reader("roofline.chain").read(rec) <= 100 + 1e-9


def test_stft_work_at_the_cell_shapes():
    cell = Cell("stft.batch64")
    nbytes = 4 * 64 * 480000 + 8 * 64 * 1873 * 1024
    assert _work("roofline.stft", cell) == pytest.approx(nbytes / 3.35e12)
    clip = Cell("stft.clip1s")
    nbytes = 4 * 48000 + 8 * 185 * 1024
    assert _work("roofline.stft", clip) == pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("metric,cell,kernel_ms", [
    # upfirdn bf16x3 0.1962 + MFCC 0.1929 ms; busy a call 0.4346 ms
    ("roofline.chain", "chain.batch64", 0.1962 + 0.1929),
    ("roofline.chain", "chain.batch64", 0.4346),
    # two-sided spectrum kernel 0.1180 ms; busy a call 0.1106 ms
    ("roofline.stft", "stft.batch64", 0.1180),
    ("roofline.stft", "stft.batch64", 0.1106),
])
def test_measured_kernel_times_read_at_most_100(metric, cell, kernel_ms):
    c = Cell(cell)
    n = 479232 if "chain" in cell else 480000
    reader = c.reader(metric)
    rec = {"fields": c.fields, "channels": 16, "samples": n,
           "trace": {"busy_s": kernel_ms * 1e-3 * 50, "calls": 50}}
    share = reader.read(rec)
    assert 0 < share <= 100
    assert share == pytest.approx(100 * _work(metric, c, 16, n)
                                  / (kernel_ms * 1e-3))


def test_no_trace_reads_nothing():
    c = Cell("chain.batch64")
    for m in ("roofline.chain", "idle_share.throughput"):
        assert c.reader(m).read({"trace": None}) is None


def test_fft_flops():
    assert peaks.fft_flops(1, 1024) == 2.5 * 1024 * 10
    assert math.isclose(peaks.least_s(3.35e12, (67e12, 67e12)), 1.0)
