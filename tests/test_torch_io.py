"""The port's WAV I/O (vv_dsp_tpu_torch.io) against the JAX package's on the
inputs of tests/test_wav.py, test_wav_batch.py and test_io_batch.py: the
port's readers give the JAX readers' bits on files written by either
package, in PCM 16/24/32 and float32, mono and stereo; its native and
numpy backends agree bit for bit; the batch loader marks a truncated or
undecodable file with frames == -1 as the JAX one does; the prefetcher
keeps order and reaps its thread on an early exit.

Both packages build csrc/wavio.cpp on first use (the JAX package under the
temporary directory, the port under build/vv_dsp_tpu_torch/wavio/), so
both libraries are loaded in this process side by side.
"""

import ctypes
import struct
import threading
import time

import numpy as np
import pytest
import torch

from vv_dsp_tpu.io import batch as jbatch
from vv_dsp_tpu.io import wav as jwav

from vv_dsp_tpu_torch import io as tio
from vv_dsp_tpu_torch.io import batch as tbatch
from vv_dsp_tpu_torch.io import wav as twav

FORMATS = (16, 24, 32, 0)


@pytest.fixture
def stereo():
    t = np.arange(4801) / 48000.0
    return np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                     0.25 * np.sin(2 * np.pi * 1000 * t)]).astype(np.float32)


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    """Both packages on their native codec, or both on numpy."""
    if request.param == "numpy":
        monkeypatch.setattr(twav, "_get_lib", lambda: None)
        monkeypatch.setattr(jwav, "_get_lib", lambda: None)
    elif twav._get_lib() is None or jwav._get_lib() is None:
        pytest.skip("no C++ toolchain for the native codec")
    return request.param


@pytest.fixture
def corpus(tmp_path):
    """12 WAVs with mixed lengths, rates, formats and channel counts
    (tests/test_wav_batch.py's), written by the JAX package."""
    rng = np.random.default_rng(7)
    paths = []
    for i in range(12):
        ch = int(rng.integers(1, 3))
        n = int(rng.integers(100, 5000))
        sr = int(rng.choice([8000, 16000, 48000]))
        x = rng.uniform(-0.9, 0.9, (ch, n)).astype(np.float32)
        p = tmp_path / f"f{i}.wav"
        jwav.write_wav(str(p), x, sr, format=FORMATS[i % 4])
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("fmt", FORMATS)
def test_reads_give_the_jax_bits(tmp_path, stereo, fmt, channels, writer):
    """wav_info and read_wav on a file written by either package: the
    JAX package's info and bits, a float32 planar CPU tensor; and the
    port writes the JAX package's bytes."""
    x = stereo[:channels]
    p = str(tmp_path / "t.wav")
    if writer == "jax":
        jwav.write_wav(p, x, 48000, format=fmt)
    else:
        tio.write_wav(p, torch.as_tensor(x), 48000, format=fmt)
        q = str(tmp_path / "j.wav")
        jwav.write_wav(q, x, 48000, format=fmt)
        with open(p, "rb") as a, open(q, "rb") as b:
            assert a.read() == b.read()
    info = tio.wav_info(p)
    assert dataclass_tuple(info) == dataclass_tuple(jwav.wav_info(p))
    assert (info.sample_rate, info.channels, info.frames) == (48000,
                                                              channels, 4801)
    got, sr = tio.read_wav(p)
    want, jsr = jwav.read_wav(p)
    assert sr == jsr == 48000
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.float32 and got.shape == (channels, 4801)
    np.testing.assert_array_equal(got.numpy(), want)


def dataclass_tuple(info):
    return (info.sample_rate, info.channels, info.bits, info.is_float,
            info.frames)


@pytest.mark.parametrize("fmt", FORMATS)
def test_native_and_numpy_backends_agree(tmp_path, stereo, fmt):
    if twav._get_lib() is None:
        pytest.skip("no C++ toolchain for the native codec")
    p = str(tmp_path / "n.wav")
    tio.write_wav(p, stereo, 48000, format=fmt)          # native write
    native, _ = tio.read_wav(p)
    numpy_read, sr = twav._read_np(p)
    np.testing.assert_array_equal(native.numpy(), numpy_read)
    q = str(tmp_path / "np.wav")
    twav._write_np(q, stereo, 48000, fmt)
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()


def test_mono_1d_clipping_and_errors(tmp_path, backend):
    p = str(tmp_path / "m.wav")
    x = np.linspace(-0.9, 0.9, 1000, dtype=np.float32)
    tio.write_wav(p, torch.as_tensor(x), 8000, format=24)
    back, sr = tio.read_wav(p)
    assert back.shape == (1, 1000) and sr == 8000
    np.testing.assert_allclose(back[0].numpy(), x, atol=2e-6)
    with pytest.raises(ValueError):
        tio.write_wav(p, x, 8000, format=12)
    with pytest.raises(ValueError):
        tio.write_wav(p, np.zeros((2, 2, 2), np.float32), 8000)
    c = str(tmp_path / "c.wav")
    tio.write_wav(c, np.array([[1.5, -1.5, 1.0, -1.0, 0.0]], np.float32),
                  8000, format=16)
    back, _ = tio.read_wav(c)
    np.testing.assert_allclose(back[0, :2].numpy(), [32767 / 32768.0, -1.0],
                               atol=1e-6)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    with pytest.raises(ValueError):
        tio.read_wav(bad)


def test_malformed_files_rejected(tmp_path, backend):
    """A header promising more data than the file holds, zero channels, no
    fmt chunk: each raises, as in the JAX package."""
    p = tmp_path / "trunc.wav"
    p.write_bytes(b"RIFF" + struct.pack("<I", 1000) + b"WAVEfmt "
                  + struct.pack("<IHHIIHH", 16, 1, 1, 8000, 16000, 2, 16)
                  + b"data" + struct.pack("<I", 1000) + b"\x00" * 10)
    p2 = tmp_path / "zch.wav"
    p2.write_bytes(b"RIFF" + struct.pack("<I", 36) + b"WAVEfmt "
                   + struct.pack("<IHHIIHH", 16, 1, 0, 8000, 0, 0, 16)
                   + b"data" + struct.pack("<I", 0))
    p3 = tmp_path / "nofmt.wav"
    p3.write_bytes(b"RIFF" + struct.pack("<I", 12) + b"WAVE" + b"data"
                   + struct.pack("<I", 4) + b"\x00" * 4)
    for read, path in ((tio.read_wav, p), (tio.wav_info, p2),
                       (tio.read_wav, p3)):
        with pytest.raises(ValueError):
            read(path)
        with pytest.raises(ValueError):
            {"read_wav": jwav.read_wav, "wav_info": jwav.wav_info}[
                read.__name__](str(path))


def test_fuzzed_files_as_the_jax_readers(tmp_path, backend):
    """Garbage, truncations and byte flips of a valid file: the port's
    reader raises where the JAX reader raises and gives its bits where it
    parses (tests/test_wav.py's fuzz, held across the packages)."""
    rng = np.random.default_rng(99)
    seed_path = tmp_path / "seed.wav"
    jwav.write_wav(str(seed_path), rng.standard_normal(256).astype(
        np.float32), 8000)
    seed = seed_path.read_bytes()
    cases = [rng.integers(0, 256, int(rng.integers(0, 400)),
                          dtype=np.uint8).tobytes() for _ in range(20)]
    cases += [seed[:int(rng.integers(0, len(seed)))] for _ in range(20)]
    for _ in range(40):
        b = bytearray(seed)
        for _ in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        cases.append(bytes(b))
    p = tmp_path / "fuzz.wav"
    parsed = 0
    for payload in cases:
        p.write_bytes(payload)
        try:
            want, jsr = jwav.read_wav(str(p))
        except ValueError:
            with pytest.raises(ValueError):
                tio.read_wav(p)
            continue
        got, sr = tio.read_wav(p)
        assert sr == jsr
        np.testing.assert_array_equal(got.numpy(), want)
        parsed += 1
    assert parsed > 0


def test_write_takes_a_tensor_of_any_layout(tmp_path):
    x = torch.as_tensor(np.random.default_rng(3).uniform(
        -0.9, 0.9, (3, 1001)), dtype=torch.float64)
    p = str(tmp_path / "a.wav")
    tio.write_wav(p, x.t().contiguous().t(), 16000, format=0)
    back, _ = tio.read_wav(p)
    assert torch.equal(back, x.float())
    y = x.float().requires_grad_(True) * 1.0
    tio.write_wav(p, y[:, ::2], 16000, format=0)
    assert torch.equal(tio.read_wav(p)[0], x.float()[:, ::2])


def _batch_equal(got, want):
    np.testing.assert_array_equal(got.data.numpy(), want.data)
    np.testing.assert_array_equal(got.frames.numpy(), want.frames)
    np.testing.assert_array_equal(got.rates.numpy(), want.rates)
    assert got.paths == want.paths and got.ok == want.ok


def test_batch_matches_jax(corpus, backend):
    got = tio.read_wav_batch(corpus)
    assert isinstance(got.data, torch.Tensor)
    assert got.data.dtype == torch.float32
    assert got.frames.dtype == torch.int64
    _batch_equal(got, jbatch.read_wav_batch(corpus))
    for i, p in enumerate(corpus):                 # and the single reads
        x, sr = tio.read_wav(p)
        assert torch.equal(got.data[i, :x.shape[0], :x.shape[1]], x)
        assert got.rates[i] == sr


def test_batch_explicit_geometry_truncates_and_pads(corpus, backend):
    got = tio.read_wav_batch(corpus, capacity_frames=1000, channels=1,
                             n_threads=3)
    assert got.data.shape == (12, 1, 1000)
    _batch_equal(got, jbatch.read_wav_batch(corpus, 1000, 1, 3))


def test_batch_backends_agree(corpus, monkeypatch):
    if twav._get_lib() is None:
        pytest.skip("no C++ toolchain for the native codec")
    native = tio.read_wav_batch(corpus)
    monkeypatch.setattr(twav, "_get_lib", lambda: None)
    fallback = tio.read_wav_batch(corpus)
    for a, b in ((native.data, fallback.data),
                 (native.frames, fallback.frames),
                 (native.rates, fallback.rates)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["truncated", "garbage"])
def test_batch_bad_file_is_isolated(corpus, tmp_path, backend, kind):
    """A truncated file (its header promises more data than it holds) or
    garbage gets frames == -1, rate 0 and zero rows, as in the JAX
    package; the other files decode."""
    bad = tmp_path / "bad.wav"
    if kind == "truncated":
        bad.write_bytes(open(corpus[0], "rb").read()[:-100])
    else:
        bad.write_bytes(b"RIFFxxxxWAVEgarbage")
    mixed = corpus[:3] + [str(bad)] + corpus[3:]
    got = tio.read_wav_batch(mixed)
    assert not got.ok
    assert got.frames[3] == -1 and got.rates[3] == 0
    assert not got.data[3].any()
    assert (got.frames[[i for i in range(13) if i != 3]] >= 0).all()
    _batch_equal(got, jbatch.read_wav_batch(mixed))


def test_empty_and_undecodable_batches_raise(tmp_path):
    with pytest.raises(ValueError):
        tio.read_wav_batch([])
    bad = tmp_path / "junk.wav"
    bad.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError):
        tio.read_wav_batch([bad])


def test_prefetch_batches_yields_all_in_order(corpus):
    chunks = [corpus[:5], corpus[5:9], corpus[9:]]
    got = list(tio.prefetch_batches(chunks, capacity_frames=2000,
                                    channels=2, depth=2))
    assert [g.paths for g in got] == [tuple(c) for c in chunks]
    want = list(jbatch.prefetch_batches(chunks, capacity_frames=2000,
                                        channels=2, depth=2))
    for g, w in zip(got, want):
        _batch_equal(g, w)


def test_prefetch_early_exit_reaps_producer(tmp_path):
    """Leaving the loop early stops the producer thread and drops the
    queued batches (tests/test_io_batch.py's)."""
    rng = np.random.default_rng(1234)
    paths = []
    for i in range(3):
        p = tmp_path / f"s{i}.wav"
        tio.write_wav(p, rng.standard_normal((1, 256)).astype("float32"),
                      8000)
        paths.append(str(p))
    before = threading.active_count()
    for _ in tio.prefetch_batches([paths] * 6, depth=1):
        break
    deadline = time.time() + 6.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_prefetch_raises_in_the_consumer(tmp_path):
    bad = tmp_path / "junk.wav"
    bad.write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="no decodable"):
        list(tbatch.prefetch_batches([[bad]]))


def test_two_codec_libraries_keep_their_own_error(tmp_path):
    """The JAX package's and the port's copies of the codec are loaded side
    by side; each keeps its own thread-local error string (g_error has
    internal linkage), so a failure in one leaves the other's alone."""
    tlib, jlib = twav._get_lib(), jwav._get_lib()
    if tlib is None or jlib is None:
        pytest.skip("no C++ toolchain for the native codec")
    assert tlib._name != jlib._name
    with pytest.raises(ValueError, match="cannot open"):
        jwav.read_wav(str(tmp_path / "absent.wav"))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    with pytest.raises(ValueError) as port_err:
        tio.read_wav(bad)
    assert "cannot open" not in str(port_err.value)
    assert "cannot open" in jlib.vv_wav_error_string().decode()
    info = twav._CInfo()
    assert tlib.vv_wav_info(str(bad).encode(), ctypes.byref(info)) != 0
