"""The benchmark's ``fir_lowpass_1024`` configuration on the CPU: the entry's
callable (``fir_apply_best`` with taps from ``design_lowpass``, its plain
path) against the configuration's float64 reference on each of the four
routes (the banded one at bf16x3, where it keeps the banded kernel), the
entry at the fields' tier whatever the matmul-precision knob says, that
reference against ``scipy.signal.lfilter``, the reference's imports,
planted faults and the control (the program at bf16x3) against the cell's
limit, and the kernel routes' per-tensor host taps and tables (read once,
read again after an in-place write, dropped with their tensor, the same
bits as host taps): the banded route's at bf16x3, the overlap-save
route's at the configuration's f32."""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import weakref

import numpy as np
import pytest
import scipy.signal
import torch

from h100bench.manifest import BENCH_DIR, ROOT, Cell
from h100bench.reference import fir_lowpass_1024 as ref
from h100bench.reference.common import MaxError
from vv_dsp_tpu_torch import config
from vv_dsp_tpu_torch.ops import filter_kernels as tfk
from vv_dsp_tpu_torch.ops.fir import design_lowpass
from torch_one_thread import one_thread

CONFIG = json.loads((BENCH_DIR / "configs" / "fir_lowpass_1024.json"
                     ).read_text())
FIELDS = CONFIG["fields"]
LIMIT = ref.LIMITS["call"]["err_of_scale"]
CPU = torch.device("cpu")
# the port's float32 plain paths against float64: taps rounded to float32
# and up to 1,024 float32 products summed an output read 1.8e-7 (16
# taps), 3.6e-7 (64) and 8.6e-7 (1,024) of scale here, so 2e-5 leaves
# over 20x room (the cell's own limit, at 1,024 taps on the whole cell, is
# held in h100bench/tests/test_h100bench_fir.py)
PORT_TOL = 2e-5


def _noise(c: int, n: int, seed: int) -> torch.Tensor:
    return torch.randn((c, n), generator=torch.Generator().manual_seed(seed))


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    acc = MaxError()
    acc.add(got, want)
    return acc.numbers()["err_of_scale"]


def _entry(fields: dict):
    return Cell("fir1024.batch64").entries().call(fields, CPU)


def _spy(monkeypatch, name: str) -> list:
    """Count the calls of filter_kernels' module-level name."""
    calls = []
    real = getattr(tfk, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(tfk, name, spy)
    return calls


@pytest.mark.parametrize("taps,route", [(16, "fir_direct"),
                                        (64, "fir_apply_mxu"),
                                        (1024, "upfirdn_banded"),
                                        (1024, "fir_os")])
@pytest.mark.parametrize("seed", [0, 2**31 + 3])
def test_entry_matches_the_reference(monkeypatch, taps, route, seed):
    fields = dict(FIELDS, fir_taps=taps)
    if route == "upfirdn_banded":   # the banded kernel's tier
        fields["algorithm"] = "bf16x3"
    call = _entry(fields)
    calls = _spy(monkeypatch, route)
    x = _noise(2, 16384, seed)
    got = call(x)
    assert calls == [route]
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _err(got, ref.call(fields, x)) < PORT_TOL


def test_entry_runs_the_fields_tier_whatever_the_knob():
    x = _noise(2, 8192, 3)
    f32 = _entry(FIELDS)(x)
    with config.matmul_precision("high"):
        assert torch.equal(_entry(FIELDS)(x), f32)
        bf16x3 = tfk.fir_apply_best(ref.taps(FIELDS), x)
    assert config.dot_algorithm(None) == "f32"
    assert torch.equal(_entry(dict(FIELDS, algorithm="bf16x3"))(x), bf16x3)
    assert config.dot_algorithm(None) == "f32"
    assert not torch.equal(bf16x3, f32)


@pytest.mark.parametrize("seed", [4, 2**31 + 9])
def test_reference_matches_scipy_lfilter(seed):
    x = _noise(3, 6000, seed).double()
    h = scipy.signal.firwin(FIELDS["fir_taps"], 2 * FIELDS["fir_cutoff"],
                            window="hamming", scale=False)
    want = scipy.signal.lfilter(h, [1.0], x.numpy(), axis=-1)
    got = ref.call(FIELDS, x).numpy()
    assert got.shape == x.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import h100bench.reference.fir_lowpass_1024; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"vv_dsp_tpu_torch", "vv_dsp_tpu", "jax", "jaxlib",
                       "flax"}


def _tap_dropped(x):
    h = ref.taps(FIELDS)
    h[len(h) // 2] = 0.0
    return tfk.fir_apply_best(h, x)


def _half_sample_shift(x):
    y = tfk.fir_apply_best(ref.taps(FIELDS), x)
    return 0.5 * (y + torch.nn.functional.pad(y, (1, 0))[..., :-1])


@pytest.mark.parametrize("fault", [
    _tap_dropped,
    lambda x: tfk.fir_apply_best(ref.taps(FIELDS), x).flip(0),
    _half_sample_shift], ids=["tap_dropped", "rows_swapped",
                              "half_sample_shift"])
def test_planted_faults_fail_the_limit(fault):
    x = _noise(2, 16384, 19)
    assert _err(fault(x), ref.call(FIELDS, x)) > 5 * LIMIT


@pytest.mark.parametrize("seed", [23, 2**31 + 23])
def test_control_reads_above_the_limit(seed):
    """The control of kind ``program``: the entry built with the control's
    fields, the program's own bf16x3 tier. Here the plain path reads
    4.25-4.29e-6 on these seeds, 1.25x the limit (the kernel on the card
    5.1-6.8e-6), and the f32 tier 1.2e-6."""
    control = ref.CONTROL["call"]
    assert control["kind"] == "program"
    x = _noise(4, 65536, seed)
    want = ref.call(FIELDS, x)
    with one_thread():
        err = _err(_entry(dict(FIELDS, **control["fields"]))(x), want)
        sound = _err(_entry(FIELDS)(x), want)
    assert sound < LIMIT < err


def test_banded_taps_read_once_and_rebuilt_after_an_in_place_write():
    h = design_lowpass(FIELDS["fir_taps"], FIELDS["fir_cutoff"],
                       device="cpu")
    x = _noise(2, 4096, 29)
    with one_thread(), config.matmul_precision("high"):
        first = tfk.fir_apply_best(h, x)
        host = tfk._host_taps(h)
        again = tfk.fir_apply_best(h, x)
        assert tfk._host_taps(h) is host and torch.equal(first, again)
        h.mul_(0.5)
        halved = tfk.fir_apply_best(h, x)
        assert tfk._host_taps(h) is not host
        np.testing.assert_array_equal(tfk._host_taps(h), 0.5 * host)
        assert not torch.equal(halved, first)
        torch.testing.assert_close(halved, 0.5 * first, rtol=1e-6,
                                   atol=1e-6 * float(first.abs().max()))
        # a fresh tensor of the same values, and the same taps on the
        # host, give the same bits
        assert torch.equal(halved, tfk.fir_apply_best(h.clone(), x))
        assert torch.equal(halved, tfk.fir_apply_best(
            h.double().numpy(), x))


def test_banded_taps_entry_dies_with_its_tensor():
    h = design_lowpass(FIELDS["fir_taps"], FIELDS["fir_cutoff"],
                       device="cpu")
    with config.matmul_precision("high"):
        tfk.fir_apply_best(h, _noise(1, 2048, 31))
    assert h in tfk._HOST_TAPS._hits
    entries = len(tfk._HOST_TAPS._hits)
    alive = weakref.ref(h)
    del h
    gc.collect()
    assert alive() is None
    assert len(tfk._HOST_TAPS._hits) == entries - 1


def test_os_table_read_once_and_rebuilt_after_an_in_place_write(
        monkeypatch):
    """The overlap-save route's table, kept per taps tensor: the taps read
    to the host and the table built once; an in-place write reads the taps
    and builds the table again, a halved filter's table halved."""
    h = design_lowpass(FIELDS["fir_taps"], FIELDS["fir_cutoff"],
                       device="cpu")
    x = _noise(2, 4096, 37)
    builds = _spy(monkeypatch, "os_table_np")
    before = tfk.fir_apply_best.route_calls["os"]
    with one_thread():
        first = tfk.fir_apply_best(h, x)
        table = tfk.os_table(h, CPU)
        host = tfk._host_taps(h)
        again = tfk.fir_apply_best(h, x)
        assert tfk.fir_apply_best.route_calls["os"] == before + 2
        assert tfk.os_table(h, CPU) is table and tfk._host_taps(h) is host
        assert builds == ["os_table_np"] and torch.equal(first, again)
        h.mul_(0.5)
        halved = tfk.fir_apply_best(h, x)
        assert tfk._host_taps(h) is not host
        assert builds == ["os_table_np"] * 2
        halved_table = tfk.os_table(h, CPU)
        assert halved_table is not table
        torch.testing.assert_close(halved_table, 0.5 * table, rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(halved, 0.5 * first, rtol=1e-6,
                                   atol=1e-6 * float(first.abs().max()))
        # a fresh tensor of the same values, and the same taps on the
        # host, give the same bits
        assert torch.equal(halved, tfk.fir_apply_best(h.clone(), x))
        assert torch.equal(halved, tfk.fir_apply_best(
            h.double().numpy(), x))


def test_os_table_entry_dies_with_its_tensor():
    h = design_lowpass(FIELDS["fir_taps"], FIELDS["fir_cutoff"],
                       device="cpu")
    tfk.fir_apply_best(h, _noise(1, 2048, 41))
    assert ("os_table", CPU) in tfk._HOST_TAPS._hits[h][1]
    entries = len(tfk._HOST_TAPS._hits)
    alive = weakref.ref(h)
    del h
    gc.collect()
    assert alive() is None
    assert len(tfk._HOST_TAPS._hits) == entries - 1
