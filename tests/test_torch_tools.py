"""The port's CLI tools (``vv_dsp_tpu_torch.tools``) against the JAX
package's (``vv_dsp_tpu.tools``) on the same fixture files, on the CPU:
each JAX tool's ``main(argv)`` and the port tool's ``main(argv + ["--cpu"])``
run in-process, and the two agree on the exit code, the line count,
``dump_mfcc``'s header lines and every value, within:

- 5e-5 of the larger max |value| for the FFT class: fft (c2c, r2c, c2r),
  dct, czt, hilbert, stats, stft_roundtrip and mfcc (the reference's
  python/test_fft.py tolerance); stft_roundtrip before its w^2 norm is
  divided out, since at the ends the norm falls to ~1e-8;
- 1e-5 of max |y| for fir, fir_coeffs, iir and resample (linear and
  sinc): float32 sums of the same products in another order.

The port's output is also held to numpy/scipy as tests/test_tools.py holds
the JAX tools', at that file's tolerances. Usage errors give the JAX
tools' exit codes and stderr (with `` [--cpu]`` added to the usage text);
without a GPU and without ``--cpu`` a tool returns 1 with
``no CUDA device; pass --cpu`` and writes nothing to stdout. One
subprocess run covers the dispatcher (``python -m vv_dsp_tpu_torch.tools``).
"""

import importlib
import io
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import signal as ss

from vv_dsp_tpu_torch.tools import TOOLS
from vv_dsp_tpu_torch.tools import __main__ as dispatcher
from vv_dsp_tpu_torch.tools import _cli
from vv_dsp_tpu_torch.ops.window import get_window_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FFT_TOL = 5e-5
FILTER_TOL = 1e-5
NO_DEVICE = "no CUDA device; pass --cpu\n"


def _jax_tool(name):
    return importlib.import_module(f"vv_dsp_tpu.tools.{name}")


def _port_tool(name):
    return importlib.import_module(f"vv_dsp_tpu_torch.tools.{name}")


def _run(module, argv, capsys, monkeypatch, stdin=None):
    """(rc, stdout, stderr) of module.main(argv) in this process."""
    capsys.readouterr()
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = module.main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def _rows(out):
    return [l for l in out.splitlines() if l.strip() and not l.startswith("#")]


def _values(out):
    """Every number on every non-header line, as float64 (a complex line
    're,im' gives two, an MFCC row n_mfcc)."""
    vals = []
    for line in _rows(out):
        vals.extend(float(v) for v in line.replace(",", " ").split())
    return np.asarray(vals)


def _rel(got, want):
    err = np.abs(got - want).max()
    return err and err / max(np.abs(got).max(), np.abs(want).max())


def _write_reals(path, x):
    with open(path, "w") as f:
        for v in x:
            f.write(f"{float(v):.9g}\n")


def _write_complex(path, x):
    with open(path, "w") as f:
        for v in x:
            f.write(f"{float(v.real):.9g},{float(v.imag):.9g}\n")


@pytest.fixture
def fixtures(tmp_path):
    """Text fixtures from a seed: reals in [-1, 1), complex values, the
    rfft of the reals (a c2r input) and a sine."""
    r = np.random.default_rng(77)
    paths = {}
    reals = (r.random(512) * 2 - 1).astype(np.float32)
    cplx = (r.random(128) + 1j * r.random(128)).astype(np.complex64)
    for name, data, write in (
            ("reals", reals, _write_reals),
            ("complex", cplx, _write_complex),
            ("half", np.fft.rfft(reals[:64]), _write_complex),
            ("sine", np.sin(2 * math.pi * 0.01 * np.arange(2048)),
             _write_reals)):
        paths[name] = str(tmp_path / f"{name}.txt")
        write(paths[name], data)
    paths["reals_data"] = reals
    paths["dir"] = str(tmp_path)
    return paths


def _czt_w(m):
    w = np.exp(-2j * math.pi / m)
    return ["--Wre", str(float(w.real)), "--Wim", str(float(w.imag))]


# (tool, argv with {name} for a fixture path, tolerance, stdin)
CASES = {
    "fft_c2c_fwd": ("dump_fft", ["--type", "c2c", "--dir", "fwd", "-n", "64",
                                 "--infile", "{complex}"], FFT_TOL, None),
    "fft_c2c_inv": ("dump_fft", ["--type", "c2c", "--dir", "inv", "-n", "96",
                                 "--infile", "{complex}"], FFT_TOL, None),
    "fft_c2c_seed": ("dump_fft", ["-n", "16", "--seed", "3"], FFT_TOL, None),
    "fft_r2c": ("dump_fft", ["--type", "r2c", "--dir", "fwd", "-n", "64",
                             "--infile", "{reals}"], FFT_TOL, None),
    "fft_r2c_seed": ("dump_fft", ["--type", "r2c", "-n", "32", "--seed",
                                  "5"], FFT_TOL, None),
    "fft_c2r": ("dump_fft", ["--type", "c2r", "--dir", "inv", "-n", "64",
                             "--infile", "{half}"], FFT_TOL, None),
    "dct2_fwd": ("dump_dct", ["--type", "2", "--dir", "fwd", "-n", "63",
                              "--infile", "{reals}"], FFT_TOL, None),
    "dct2_inv": ("dump_dct", ["--type", "2", "--dir", "inv", "-n", "64",
                              "--infile", "{reals}"], FFT_TOL, None),
    "dct3_fwd": ("dump_dct", ["--type", "3", "-n", "16", "--infile",
                              "{reals}"], FFT_TOL, None),
    "dct4_inv": ("dump_dct", ["--type", "4", "--dir", "inv", "-n", "8",
                              "--infile", "{reals}"], FFT_TOL, None),
    "dct_default_input": ("dump_dct", ["-n", "16"], FFT_TOL, None),
    "czt_dft": ("dump_czt", ["--N", "50", "--M", "50", *_czt_w(50),
                             "--Are", "1.0", "--Aim", "0.0", "--infile",
                             "{reals}"], FFT_TOL, None),
    # a zoom band on the unit circle: a contour off it (|W| != 1) grows
    # as |W|^(-n^2/2), beyond float32 in both packages
    "czt_complex_zoom": ("dump_czt", ["--N", "64", "--M", "32",
                                      *_czt_w(128), "--Are", "0.8",
                                      "--Aim", "0.6", "--infile",
                                      "{complex}", "--complex"], FFT_TOL,
                         None),
    "hilbert": ("dump_hilbert", ["-n", "256", "--fs", "1000.0", "--f",
                                 "125.0", "--phase", "0.0"], FFT_TOL, None),
    "hilbert_defaults": ("dump_hilbert", ["-n", "100", "--phase", "0.3"],
                         FFT_TOL, None),
    "stats_unbiased": ("dump_stats", ["autocorr", "128", "0"], FFT_TOL,
                       "reals"),
    "stats_biased": ("dump_stats", ["autocorr", "64"], FFT_TOL, "reals"),
    "fir": ("dump_fir", ["--num-taps", "31", "--cutoff", "0.25", "--win",
                         "hamming", "--n", "256", "--infile", "{reals}",
                         "--dump-coeffs", "{dir}/h.txt"], FILTER_TOL, None),
    "fir_seed": ("dump_fir", ["--num-taps", "16", "--cutoff", "0.1", "--win",
                              "hann", "--n", "200", "--seed", "4"],
                 FILTER_TOL, None),
    "fir_coeffs": ("dump_fir_coeffs", ["--num-taps", "31", "--cutoff",
                                       "0.25", "--win", "hann"], FILTER_TOL,
                   None),
    "fir_coeffs_blackman": ("dump_fir_coeffs", ["--num-taps", "64",
                                                "--cutoff", "0.1", "--win",
                                                "blackman"], FILTER_TOL,
                            None),
    "iir": ("dump_iir", ["--b0", "0.2929", "--b1", "0.5858", "--b2",
                         "0.2929", "--a1", "-0.0", "--a2", "0.1716", "--n",
                         "256", "--infile", "{reals}"], FILTER_TOL, None),
    "iir_seed": ("dump_iir", ["--b0", "0.5", "--a1", "0.9", "--a2", "-0.3",
                              "--n", "100", "--seed", "2"], FILTER_TOL,
                 None),
    "resample_linear": ("dump_resample", ["--num", "2", "--den", "1",
                                          "--quality", "linear", "--infile",
                                          "{reals}"], FILTER_TOL, None),
    "resample_linear_seed": ("dump_resample", ["--num", "3", "--den", "2",
                                               "--n", "100", "--seed", "2"],
                             FILTER_TOL, None),
    "resample_sinc": ("dump_resample", ["--num", "2", "--den", "1",
                                        "--quality", "sinc:32", "--infile",
                                        "{sine}"], FILTER_TOL, None),
    "resample_sinc_down": ("dump_resample", ["--num", "3", "--den", "4",
                                             "--quality", "sinc:16",
                                             "--infile", "{reals}"],
                           FILTER_TOL, None),
    "stft_roundtrip": ("dump_stft_roundtrip", ["--fft", "256", "--hop",
                                               "128", "--win", "hann", "--n",
                                               "2048", "--infile",
                                               "{sine}"], FFT_TOL, None),
    "stft_roundtrip_seed": ("dump_stft_roundtrip", ["--fft", "64", "--hop",
                                                    "16", "--win", "hamming",
                                                    "--n", "500", "--seed",
                                                    "1"], FFT_TOL, None),
    "stft_roundtrip_short": ("dump_stft_roundtrip", ["--fft", "128", "--hop",
                                                     "128", "--win",
                                                     "boxcar", "--n", "100",
                                                     "--seed", "1"], FFT_TOL,
                             None),
    "mfcc": ("dump_mfcc", ["--n-mels", "26", "--n-mfcc", "13"], FFT_TOL,
             None),
    "mfcc_options": ("dump_mfcc", ["--sample-rate", "22050", "--n-fft",
                                   "1024", "--n-mels", "40", "--n-mfcc",
                                   "20", "--fmin", "100", "--fmax", "8000",
                                   "--lifter", "0"], FFT_TOL, None),
    "mfcc_output": ("dump_mfcc", ["--output", "{dir}/mfcc.txt"], FFT_TOL,
                    None),
}


def _ola_norm(argv):
    """dump_stft_roundtrip's w^2 overlap-add norm, in float64."""
    flags = dict(zip(argv[::2], argv[1::2]))
    nfft, hop, n = int(flags["--fft"]), int(flags["--hop"]), int(flags["--n"])
    w2 = get_window_np(flags["--win"], nfft) ** 2
    norm = np.zeros(n)
    for f in range(0 if n < nfft else (n - nfft) // hop + 1):
        norm[f * hop:f * hop + nfft] += w2
    return norm


def _argv(args, fixtures):
    return [a.format(**fixtures) for a in args]


def _stdin(kind, fixtures):
    if kind is None:
        return None
    return "\n".join(f"{float(v):.9g}" for v in fixtures["reals_data"])


# the file a case writes besides stdout
SIDE_FILES = {"fir": "h.txt", "mfcc_output": "mfcc.txt"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_matches_jax(case, fixtures, capsys, monkeypatch):
    tool, args, tol, stdin = CASES[case]
    argv = _argv(args, fixtures)
    feed = _stdin(stdin, fixtures)
    side = SIDE_FILES.get(case)
    rc_j, out_j, err_j = _run(_jax_tool(tool), argv, capsys, monkeypatch,
                              feed)
    side_j = (open(os.path.join(fixtures["dir"], side)).read()
              if side else None)
    rc_t, out_t, err_t = _run(_port_tool(tool), argv + ["--cpu"], capsys,
                              monkeypatch, feed)
    assert rc_j == rc_t == 0, (err_j, err_t)
    assert len(out_t.splitlines()) == len(out_j.splitlines())
    headers = [[l for l in o.splitlines() if l.startswith("#")]
               for o in (out_j, out_t)]
    assert headers[0] == headers[1]
    got, want = _values(out_t), _values(out_j)
    assert got.shape == want.shape
    if tool == "dump_stft_roundtrip":
        # held before the w^2 norm is divided out (chip_smoke.py's ISTFT
        # rule): where it falls to ~1e-8 at the ends, y is the quotient of
        # two numbers at float32 noise in both packages
        got, want = got * _ola_norm(argv), want * _ola_norm(argv)
    if got.size:
        assert _rel(got, want) < tol
    if side:
        side_t = open(os.path.join(fixtures["dir"], side)).read()
        assert side_t.count("\n") == side_j.count("\n")
        assert _rel(_values(side_t), _values(side_j)) < tol
    if tool == "dump_hilbert":   # avg_ifreq=%g Hz manual=%g on stderr
        fj = [float(v.split("=")[1].split()[0]) for v in err_j.split()[::2]]
        ft = [float(v.split("=")[1].split()[0]) for v in err_t.split()[::2]]
        assert _rel(np.asarray(ft), np.asarray(fj)) < tol
    else:
        assert err_t == err_j


def test_bench_czt_matches_jax(capsys, monkeypatch):
    rc_j, out_j, _ = _run(_jax_tool("bench_czt"), ["128", "128", "2"],
                          capsys, monkeypatch)
    rc_t, out_t, _ = _run(_port_tool("bench_czt"), ["128", "--cpu", "128",
                                                    "2"], capsys,
                          monkeypatch)
    assert rc_j == rc_t == 0
    lj, lt = out_j.splitlines(), out_t.splitlines()
    assert len(lj) == len(lt) == 2
    assert lt[0].startswith("CZT bench: N=128 M=128 iters=2 avg=")
    assert lt[0].endswith(" ms") and float(lt[0].split("avg=")[1][:-3]) > 0
    assert lt[1] == lj[1] == "Peak bin: 37"


# --- the port's output against numpy/scipy (tests/test_tools.py) ----------

def _port(tool, argv, capsys, monkeypatch, stdin=None):
    rc, out, err = _run(_port_tool(tool), list(map(str, argv)) + ["--cpu"],
                        capsys, monkeypatch, stdin)
    assert rc == 0, err
    return out


def _complex(out):
    v = _values(out)
    return v[0::2] + 1j * v[1::2]


@pytest.mark.parametrize("n", [16, 64, 96])
def test_port_fft_c2c_matches_numpy(tmp_path, rng, capsys, monkeypatch, n):
    x = (rng.random(n) + 1j * rng.random(n)).astype(np.complex64)
    p = tmp_path / "in.txt"
    _write_complex(p, x)
    out = _complex(_port("dump_fft", ["--type", "c2c", "--dir", "fwd", "-n",
                                      n, "--infile", p], capsys,
                         monkeypatch))
    np.testing.assert_allclose(out, np.fft.fft(x), rtol=5e-5, atol=5e-5)


def test_port_fft_r2c_c2r_match_numpy(tmp_path, rng, capsys, monkeypatch):
    n = 64
    x = rng.random(n).astype(np.float32)
    p = tmp_path / "in.txt"
    _write_reals(p, x)
    out = _complex(_port("dump_fft", ["--type", "r2c", "--dir", "fwd", "-n",
                                      n, "--infile", p], capsys,
                         monkeypatch))
    np.testing.assert_allclose(out, np.fft.rfft(x), rtol=5e-5, atol=5e-5)
    p2 = tmp_path / "in2.txt"
    _write_complex(p2, np.fft.rfft(x))
    back = _values(_port("dump_fft", ["--type", "c2r", "--dir", "inv", "-n",
                                      n, "--infile", p2], capsys,
                         monkeypatch))
    np.testing.assert_allclose(back, x, rtol=5e-5, atol=5e-5)


def test_port_fir_matches_lfilter(tmp_path, rng, capsys, monkeypatch):
    n, taps = 256, 31
    x = (rng.random(n) * 2 - 1).astype(np.float32)
    p = tmp_path / "x.txt"
    _write_reals(p, x)
    cpath = tmp_path / "h.txt"
    out = _values(_port("dump_fir", ["--num-taps", taps, "--cutoff", 0.25,
                                     "--win", "hamming", "--n", n,
                                     "--infile", p, "--dump-coeffs", cpath],
                        capsys, monkeypatch))
    h = _values(cpath.read_text())
    assert len(h) == taps
    np.testing.assert_allclose(out, ss.lfilter(h, [1.0], x), rtol=3e-3,
                               atol=3e-3)
    np.testing.assert_allclose(h, h[::-1], rtol=1e-6, atol=1e-8)


def test_port_iir_matches_lfilter(tmp_path, rng, capsys, monkeypatch):
    n = 256
    x = (rng.random(n) * 2 - 1).astype(np.float32)
    p = tmp_path / "x.txt"
    _write_reals(p, x)
    b = [0.2929, 0.5858, 0.2929]
    a1, a2 = -0.0, 0.1716
    out = _values(_port("dump_iir", ["--b0", b[0], "--b1", b[1], "--b2",
                                     b[2], "--a1", a1, "--a2", a2, "--n", n,
                                     "--infile", p], capsys, monkeypatch))
    np.testing.assert_allclose(out, ss.lfilter(b, [1.0, -a1, -a2], x),
                               rtol=3e-3, atol=3e-3)


def test_port_stft_roundtrip(tmp_path, capsys, monkeypatch):
    n, nfft, hop = 2048, 256, 128
    x = np.sin(2 * math.pi * 0.01 * np.arange(n)).astype(np.float32)
    p = tmp_path / "x.txt"
    _write_reals(p, x)
    out = _values(_port("dump_stft_roundtrip", ["--fft", nfft, "--hop", hop,
                                                "--win", "hann", "--n", n,
                                                "--infile", p], capsys,
                        monkeypatch))
    assert len(out) == n
    np.testing.assert_allclose(out[nfft:-nfft], x[nfft:-nfft], rtol=5e-2,
                               atol=5e-2)


def test_port_czt_dft_equivalence(tmp_path, rng, capsys, monkeypatch):
    n = 50
    x = (rng.random(n) * 2 - 1).astype(np.float32)
    p = tmp_path / "x.txt"
    _write_reals(p, x)
    w = np.exp(-2j * math.pi / n)
    out = _complex(_port("dump_czt", ["--N", n, "--M", n, "--Wre", w.real,
                                      "--Wim", w.imag, "--Are", 1.0, "--Aim",
                                      0.0, "--infile", p], capsys,
                         monkeypatch))
    np.testing.assert_allclose(out, np.fft.fft(x), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n", [7, 8, 63, 64, 257])
def test_port_dct_roundtrip(tmp_path, rng, capsys, monkeypatch, n):
    x = (rng.random(n) * 2 - 1).astype(np.float32)
    p = tmp_path / "x.txt"
    _write_reals(p, x)
    fwd = _values(_port("dump_dct", ["--type", 2, "--dir", "fwd", "-n", n,
                                     "--infile", p], capsys, monkeypatch))
    p2 = tmp_path / "y.txt"
    _write_reals(p2, fwd)
    back = _values(_port("dump_dct", ["--type", 2, "--dir", "inv", "-n", n,
                                      "--infile", p2], capsys, monkeypatch))
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4)


def test_port_dct_default_input(capsys, monkeypatch):
    a = _values(_port("dump_dct", ["--type", 2, "--dir", "fwd", "-n", 16],
                      capsys, monkeypatch))
    x = (np.arange(16) % 7).astype(np.float64)
    want = np.array([np.sum(x * np.cos(np.pi * (np.arange(16) + 0.5) * k
                                       / 16)) for k in range(16)])
    np.testing.assert_allclose(a, want, rtol=1e-4, atol=1e-4)


def test_port_resample_linear(tmp_path, rng, capsys, monkeypatch):
    n, num, den = 256, 2, 1
    x = (rng.random(n) * 2 - 1).astype(np.float32)
    p = tmp_path / "x.txt"
    _write_reals(p, x)
    out = _values(_port("dump_resample", ["--num", num, "--den", den,
                                          "--quality", "linear", "--infile",
                                          p], capsys, monkeypatch))
    out_n = (n - 1) * num // den + 1
    assert len(out) == out_n
    want = np.interp(np.arange(out_n) * den / num, np.arange(n), x)
    np.testing.assert_allclose(out, want, rtol=5e-2, atol=5e-2)


def test_port_resample_sinc_tone(tmp_path, capsys, monkeypatch):
    x = np.sin(2 * math.pi * 0.02 * np.arange(512)).astype(np.float32)
    p = tmp_path / "x.txt"
    _write_reals(p, x)
    out = _values(_port("dump_resample", ["--num", 2, "--den", 1,
                                          "--quality", "sinc:32", "--infile",
                                          p], capsys, monkeypatch))
    want = np.sin(2 * math.pi * 0.02 * (np.arange(len(out)) / 2))
    np.testing.assert_allclose(out[64:-64], want[64:-64], atol=0.05)


def test_port_stats_autocorr(rng, capsys, monkeypatch):
    n = 128
    x = (rng.random(n) * 2 - 1).astype(np.float32)
    stdin = "\n".join(f"{float(v):.9g}" for v in x)
    out = _values(_port("dump_stats", ["autocorr", n, 0], capsys,
                        monkeypatch, stdin))
    want = np.array([np.dot(x[:n - k], x[k:]) / (n - k) for k in range(n)])
    np.testing.assert_allclose(out[:n - 1], want[:n - 1], rtol=1e-4,
                               atol=1e-4)


def test_port_hilbert(capsys, monkeypatch):
    xa = _complex(_port("dump_hilbert", ["-n", 256, "--fs", 1000.0, "--f",
                                         125.0, "--phase", 0.0], capsys,
                        monkeypatch))
    assert len(xa) == 256
    x = np.sin(2 * math.pi * 125.0 * np.arange(256) / 1000.0)
    np.testing.assert_allclose(xa.real, x, atol=1e-3)


def test_port_mfcc_format(capsys, monkeypatch):
    out = _port("dump_mfcc", ["--n-mels", 26, "--n-mfcc", 13], capsys,
                monkeypatch)
    rows = _rows(out)
    assert len(rows) == 10
    assert all(len(r.split()) == 13 for r in rows)
    assert rows[0] == rows[1]


# --- usage errors, exit codes, the device rule, the dispatcher ------------

USAGE_ERRORS = {
    "dump_fft": ["--bogus"], "dump_fir": ["--win", "kaiser"],
    "dump_fir_coeffs": ["--num-taps"], "dump_iir": ["-h"],
    "dump_stft_roundtrip": ["--win", "bartlett"],
    "dump_resample": ["--help"], "dump_czt": ["--N", "8", "--M", "8"],
    "dump_dct": ["--type", "5"], "dump_stats": ["autocorr"],
    "dump_hilbert": ["--phase"], "dump_mfcc": ["--n-fft", "512", "--x"],
}


@pytest.mark.parametrize("tool", sorted(USAGE_ERRORS))
def test_usage_errors_match_jax(tool, capsys, monkeypatch):
    argv = USAGE_ERRORS[tool]
    rc_j, out_j, err_j = _run(_jax_tool(tool), argv, capsys, monkeypatch)
    rc_t, out_t, err_t = _run(_port_tool(tool), argv + ["--cpu"], capsys,
                              monkeypatch)
    assert rc_j == rc_t == 2
    assert out_j == out_t == ""
    assert err_t != err_j and " [--cpu]" in err_t
    assert err_t.replace(" [--cpu]", "") == err_j


@pytest.mark.parametrize("tool,argv,stdin,rc,err", [
    ("dump_stats", ["autocorr", "8"], "1 2 3", 4, ""),
    ("dump_stats", ["xcorr", "3"], "1 2 3", 2, "unknown command\n"),
    ("dump_mfcc", ["--n-mels", "10", "--n-mfcc", "13"], None, 1,
     "Error: n_mfcc cannot be larger than n_mels\n"),
    ("dump_mfcc", ["--fmin", "9000", "--sample-rate", "16000"], None, 1,
     "Error: fmin must be less than fmax\n"),
])
def test_exit_codes_match_jax(tool, argv, stdin, rc, err, capsys,
                              monkeypatch):
    got_j = _run(_jax_tool(tool), argv, capsys, monkeypatch, stdin)
    got_t = _run(_port_tool(tool), ["--cpu"] + argv, capsys, monkeypatch,
                 stdin)
    assert got_j == got_t == (rc, "", err)


NO_GPU_ARGS = {
    "dump_fft": [], "dump_fir": [], "dump_fir_coeffs": [], "dump_iir": [],
    "dump_stft_roundtrip": [], "dump_resample": [],
    "dump_czt": ["--N", "8", "--M", "8", "--infile", "{reals}"],
    "dump_dct": [], "dump_stats": ["autocorr", "8"], "dump_hilbert": [],
    "dump_mfcc": [], "bench_czt": ["64", "64", "1"],
}


@pytest.mark.parametrize("tool", TOOLS)
def test_no_gpu_without_cpu_flag_fails(tool, fixtures, capsys, monkeypatch):
    """No silent CPU fallback: the card or nothing."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tools run on it")
    argv = _argv(NO_GPU_ARGS[tool], fixtures)
    got = _run(_port_tool(tool), argv, capsys, monkeypatch,
               "0.5 " * 8 if tool == "dump_stats" else None)
    assert got == (1, "", NO_DEVICE)


def test_take_device():
    assert _cli.take_device(["-n", "8"]) == (["-n", "8"], "cuda")
    assert _cli.take_device(["--cpu", "-n", "8", "--cpu"]) == (["-n", "8"],
                                                              "cpu")


def test_tool_list_matches_jax():
    from vv_dsp_tpu.tools import TOOLS as JAX_TOOLS
    assert TOOLS == JAX_TOOLS
    for name in TOOLS:
        assert callable(_port_tool(name).main)
    from vv_dsp_tpu.tools.dump_fir import WIN_MAP
    assert _port_tool("dump_fir").WIN_MAP == WIN_MAP


def test_dispatcher_subprocess_matches_jax(fixtures, capsys, monkeypatch):
    argv = ["--type", "r2c", "--dir", "fwd", "-n", "64", "--infile",
            fixtures["reals"]]
    res = subprocess.run([sys.executable, "-m", "vv_dsp_tpu_torch.tools",
                          "dump_fft", *argv, "--cpu"], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
    _, want, _ = _run(_jax_tool("dump_fft"), argv, capsys, monkeypatch)
    assert len(res.stdout.splitlines()) == len(want.splitlines()) == 33
    assert _rel(_values(res.stdout), _values(want)) < FFT_TOL


@pytest.mark.parametrize("argv", [[], ["dump_nothing", "--cpu"]])
def test_dispatcher_usage(argv, capsys):
    assert dispatcher.main(argv) == 2
    out, err = capsys.readouterr()
    assert out == "" and err.startswith("usage: python -m "
                                        "vv_dsp_tpu_torch.tools <tool>")
    assert err.splitlines()[1] == "tools: " + " ".join(TOOLS)
