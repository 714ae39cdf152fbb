"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU:
the bench record's fields, positive rates from ``benchmark`` and
``chain_benchmark`` on CPU tensors, the three roofline functions equal to
JAX's at ``chip="cpu"`` (to 1e-12 relative: the same float64 formulas),
the H100 entry's bandwidth/compute split, ``detect_chip`` and the trace.
Device times come only from a run on the card (chip_smoke.py)."""

import dataclasses
import json
import os

import pytest
import torch

from vv_dsp_tpu.utils import profiling as jprof
from vv_dsp_tpu_torch.utils import profiling as tprof

SHAPES = [(16, 480000, 64), (1, 1024, 1), (4, 48000, 4096), (2, 12345, 33)]


def test_bench_result_matches_jax():
    names = [f.name for f in dataclasses.fields(jprof.BenchResult)]
    assert [f.name for f in dataclasses.fields(tprof.BenchResult)] == names
    args = ("x", 1.5, 2e6, 0.25, 7)
    assert (json.loads(tprof.BenchResult(*args).to_json())
            == json.loads(jprof.BenchResult(*args).to_json()))


def test_benchmark_on_cpu_tensors():
    x = torch.ones((4, 48000))
    r = tprof.benchmark("double", lambda v: v * 2.0, x, iters=3, warmup=1)
    assert r.name == "double" and r.iterations == 3
    assert r.elapsed_ms > 0 and r.samples_per_sec > 0 and r.rtf > 0
    assert r.samples_per_sec * r.elapsed_ms / 1e3 == pytest.approx(4 * 48000)
    assert set(json.loads(r.to_json())) == {
        "name", "elapsed_ms", "samples_per_sec", "rtf", "iterations"}


def test_chain_benchmark_feeds_each_call_the_last():
    x = torch.ones((2, 1000))
    seen = []

    def step(v, acc):
        seen.append(float(acc))
        return (v + acc * 1e-30).sum() * 0 + acc + 1

    r = tprof.chain_benchmark("chain", step, x, iters=5, repeats=2)
    assert r.iterations == 5 and r.elapsed_ms > 0 and r.samples_per_sec > 0
    assert seen == [0.0, 1.0, 2.0, 3.0, 4.0] * 3   # warm-up + 2 repeats


@pytest.mark.parametrize("channels,n,taps", SHAPES)
def test_rooflines_match_jax_on_cpu(channels, n, taps):
    pairs = [
        (tprof.fir_roofline(channels, n, taps, chip="cpu"),
         jprof.fir_roofline(channels, n, taps, chip="cpu")),
        (tprof.stft_roofline(channels, n // 256 + 1, 4 * taps + 4,
                             chip="cpu"),
         jprof.stft_roofline(channels, n // 256 + 1, 4 * taps + 4,
                             chip="cpu")),
        (tprof.resample_roofline(channels, n * 4 // 3, taps, n, chip="cpu"),
         jprof.resample_roofline(channels, n * 4 // 3, taps, n,
                                 chip="cpu")),
    ]
    for got, want in pairs:
        for name in ("flops", "hbm_bytes", "attainable_seconds"):
            assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                       rel=1e-12)
        assert got.compute_bound == want.compute_bound
        assert got.achieved_fraction(1e-3) == pytest.approx(
            want.achieved_fraction(1e-3), rel=1e-12)


def test_h100_roofline():
    """The JAX test's split at the H100's peaks (67 TFLOP/s f32, 3.35
    TB/s): a 64-tap FIR is bandwidth-bound, 4,096 taps compute-bound."""
    assert tprof.CHIP_SPECS == {"h100": (67.0, 3350.0), "cpu": (0.5, 50.0)}
    r = tprof.fir_roofline(16, 480000, 64, chip="h100")
    assert r.attainable_seconds > 0 and not r.compute_bound
    assert r.attainable_seconds == pytest.approx(4.0 * 16 * (2 * 480000 + 64)
                                                 / 3350e9)
    assert tprof.fir_roofline(16, 480000, 4096, chip="h100").compute_bound
    assert r.achieved_fraction(r.attainable_seconds * 2) == pytest.approx(0.5)


def test_detect_chip_and_unknown_chips(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: detect_chip reads its name")
    assert tprof.detect_chip() == "cpu"
    assert tprof.Roofline(1.0, 1.0).attainable_seconds == pytest.approx(
        tprof.Roofline(1.0, 1.0, chip="cpu").attainable_seconds)
    with pytest.raises(KeyError, match="v5e"):
        tprof.Roofline(1.0, 1.0, chip="v5e").attainable_seconds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert tprof.detect_chip() == "h100"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100"):
        tprof.detect_chip()


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as where:
        torch.ones(64).sum()
    assert where == log_dir
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        assert json.load(f)["traceEvents"]
