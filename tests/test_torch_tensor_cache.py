"""``utils.tensor_cache.PerTensor``, the cache the wrappers keep of what they
work out on the host from a tensor they are given, and its three sites on
the CPU: ``mma_plan.band_parts`` (the banded kernel's B parts of a taps
table), ``stft_kernels._mel_tables`` (the MFCC kernel's compact
filterbank) and ``filter_kernels._host_taps`` (tested with its route in
``test_torch_fir_config.py``)."""

from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest
import torch

from vv_dsp_tpu_torch.ops import mma_plan
from vv_dsp_tpu_torch.ops import stft_kernels as tsk
from vv_dsp_tpu_torch.ops.mel import mel_filterbank_np
from vv_dsp_tpu_torch.ops.upfirdn import polyphase_table
from vv_dsp_tpu_torch.utils.tensor_cache import PerTensor


def test_per_tensor_keeps_rebuilds_and_drops():
    cache, built = PerTensor(), []

    def build(v):
        built.append(v)
        return v

    t = torch.zeros(4)
    assert cache.get(t, "a", lambda: build(1)) == 1
    assert cache.get(t, "a", lambda: build(2)) == 1
    assert cache.get(t, "b", lambda: build(3)) == 3
    assert built == [1, 3] and t in cache._hits
    t.add_(1.0)
    assert cache.get(t, "a", lambda: build(4)) == 4
    # the other key went with the old version
    assert cache.get(t, "b", lambda: build(5)) == 5
    assert built == [1, 3, 4, 5]
    # another tensor of the same values has entries of its own
    assert cache.get(t.clone(), "a", lambda: build(6)) == 6
    alive = weakref.ref(t)
    del t
    gc.collect()
    assert alive() is None and len(cache._hits) == 0


@pytest.mark.parametrize("algorithm", ["f32", "bf16x3", "bf16"])
def test_band_parts_kept_per_table_and_rebuilt_after_a_write(algorithm):
    h = np.hanning(96)
    table = polyphase_table(h, 4, "cpu").clone()
    p = mma_plan.upfirdn_plan(4, 3, table.shape[1], 0, algorithm)
    parts = mma_plan.band_parts(table, p, algorithm)
    assert parts.dtype == torch.bfloat16 and parts.is_contiguous()
    assert mma_plan.band_parts(table, p, algorithm) is parts
    np.testing.assert_array_equal(
        parts.float().numpy(),
        mma_plan.band_parts_np(table.numpy(), p, algorithm).astype(
            np.float32))
    table.mul_(2.0)
    twice = mma_plan.band_parts(table, p, algorithm)
    assert twice is not parts
    torch.testing.assert_close(twice.float(), 2.0 * parts.float(),
                               rtol=0, atol=0)


def test_mel_tables_follow_the_filterbank_and_its_bands():
    fb_np = mel_filterbank_np(512, 20, 16000.0, 0.0, 8000.0)
    fb = torch.as_tensor(fb_np)
    bands = torch.as_tensor(tsk.band_edges_np(fb_np))
    first = tsk._mel_tables(fb, bands)
    assert tsk._mel_tables(fb, bands) is first
    # other bands of the same values: an entry of their own, equal tables
    other = tsk._mel_tables(fb, bands.clone())
    assert other is not first
    assert all(torch.equal(a, b) for a, b in zip(other, first))
    fb.mul_(0.5)
    halved = tsk._mel_tables(fb, bands)
    assert halved is not first
    torch.testing.assert_close(halved[0], 0.5 * first[0])
    bad = bands.clone()
    bad[1, 0] = fb.shape[1] + 1
    with pytest.raises(ValueError):
        tsk._mel_tables(fb, bad)
