"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit (nvidia-smi);
2. build: compile the port's CUDA kernels from vv_dsp_tpu_torch/csrc,
   failing if ptxas spills in any instance of the two tensor-core kernels
   (csrc/upfirdn.cu, csrc/dft_power.cu), of the packed MFCC and power
   kernels (csrc/stft.cu), of the full-nfft inverse, fused gate, mel/MFCC
   and power kernels (csrc/stockham.cu), of the packed inverse
   (csrc/istft.cu), of the packed fused gate (csrc/gate_packed.cu) or of
   the per-phase resampler (csrc/filter.cu);
3. kernels: each kernel of the path against its plain PyTorch version on
   the card, at the shapes the main path gives it (the MFCC kernel at the
   chain's and at MFCCFrontend's geometry), within its tolerance,
   with CUDA-event times of both, of one PyTorch library call computing
   the same function where there is one, and the bound reckoned from the
   shapes. The full-nfft kernels are held the same way at the shapes
   their entry points give them (power, mel/MFCC and the fused gate at
   128/32 on (16, 479232), the spectrum at 512/8 on (16, 480000), with the
   packed spectrum kernel timed on that input), and at one geometry of
   the other kind each on 2 channels (1024/8 for power, mel and gate;
   128/32 and 2048/16 for the spectrum). The two spectrum kernels share
   the register-resident FFT of csrc/fft_reg.cuh: the packed one is also
   held at the ends of its range on 2 channels (256/64, 4096/1024), and
   each main-path row of the two prints kernel, torch.stft and bound ms,
   the bound's share and the registers ptxas gave the kernel (build.log);
   so does each main-path row of the MFCC kernel, of the full-nfft
   inverse, fused gate (threshold 0 and 0.1) and mel/MFCC kernel, of the
   packed inverse (without and with the gate), of the packed fused gate
   and of the two power kernels (1024/256 packed, 128/32 and 1024/8
   full-nfft), which run the same transform (a redesign line: kernel and
   bound ms, the bound's share, ptxas's figures, the plan's dynamic shared
   memory; the power rows with the one-sided spectrum kernel's time at the
   same geometry, their yardstick, since no PyTorch call computes the
   power in one pass); the packed inverse's rows also print its spectrum
   stage's tally (istft_kernels.ring_tally: groups walked, and the share
   whose rows had landed when their block first looked) over one call
   under a profiler, held to the walk's count (fft_plan.istft_groups).
   The two tensor-core kernels print the same row (kernel and bound ms,
   the bound's share, ptxas's figures): the banded upfirdn at each tier at
   the chain head, each against its own tier's bound (f32 the lesser of
   its float32 FMAs on the CUDA cores and its six bf16 products), and the
   windowed-DFT power with its byte bound, the product form's floor (six
   bf16 products at 989 TFLOP/s) and the rate its products ran at.
   On 2 channels the upfirdn also takes the layouts the chain head does
   not: the fused head at 8/7 (B's slice in column blocks), 16,384 taps
   (B streamed in depth chunks) and 1/1000 (A's rows copied).
   The direct FIR at 16 taps and the per-phase
   resampler at 4/3 on (16, 479232) beside its plain version, then at 4/3,
   2/1, 1/2, 3/4 and 7/5 on 16 channels (x cut to a multiple of down),
   each with its error against the plain version and float64 scipy, its
   bound, the banded upfirdn and the strided F.conv1d + transpose timed on
   the same input, and a redesign line (ptxas's registers and spills of
   every instance, which may not spill, and the plan's shared memory);
   then on 2 channels at taps 1, 7, 129, n < taps and ratios 2/1, 1/2,
   3/4, 7/5, 1/25, 24/1, 24/23. The windowed-DFT power at 1024/256 on
   (16, 480000), with the packed power kernel timed beside it, then on 2
   channels at 2048/512, 1024/1024, n < nfft, 384/128, 640/128, 1536/512
   and 4096/128; the full-nfft inverse at
   1024/256 on the COLA-padded input's (16, 1876, 513) one-sided spectrum
   (the packed inverse timed beside it), on a non-Hermitian (16, 1876,
   1024) spectrum with all bins inverted, and at 128/32 on (16, 14974,
   65); the packed fused gate at 1024/256 on the COLA-padded (16, 480768)
   input at threshold 0, on the tone probe and at the gate's threshold
   (SpectralGate's split pair timed beside it). The overlap-save FIR
   kernel at 1,024 taps on (16, 479232) against its plain version, with
   the banded kernel's f32 tier, fir_apply_mxu, the bound and ptxas's
   figures, edge checks at 512 and 2,048 taps on 2 channels, and the taps
   sweep (128 to 2,048 at 16 and 64 channels: the overlap-save kernel, the
   banded kernel at f32 and fir_apply_mxu). Each of the 15 kernel
   wrappers at 65,536 rows of a short signal: two launches (65,535 rows
   and 1), against its plain version. Savitzky-Golay's kernel path, the
   banded upfirdn at 1/1 and offset wl - 1, at savgol_filter(x, 31, 3)'s
   shapes against its plain version (the shift-add correlation), with
   F.conv1d, the bound, ptxas's figures and float64 scipy, then at wl 5,
   101, 257 and deriv 1 on 2 channels; the filter tier at 1,024 taps
   (fir_apply_os, fir_apply_fft and F.conv1d timed beside fir_apply_best,
   which runs the overlap-save kernel, with its kernel time, bound and
   launches, each held to float64 lfilter; filtfilt_fir to a float64
   oracle of its
   form); the core API (DCTs, statistics, framing, FFT extras) against its
   CPU results. Then tier probes, inputs
   on which a kernel must match the plain version at its own tier and land
   beyond the limit against another tier (the controls);
4. slice: through the public entry points, each with every launch counter
   zeroed just before it and read just after, NorthStarChain on
   (16, 479232), STFT(1024, 256).process on (16, 480000), SpectralGate() on
   (16, 479232), the natural-order and the packed STFT 1024/256 roundtrips
   on (16, 479232), STFT(1024, 256).power on (16, 480000),
   MFCCFrontend() on (16, 479232), then the full-nfft paths:
   STFT(128, 32).power, MFCCFrontend(128, 32, 26 mels, 13 MFCCs, 8 kHz)
   and SpectralGate(128, 32) on (16, 479232), and STFT(512, 8).process
   two- and one-sided on (16, 480000); then the filter and resample entry
   points on (16, 479232): NorthStarChain(fused_head=False),
   fir_apply_best at 16, 64, 256 and 1024 taps, resample_poly_best at 2/1,
   1/2, 4/3 and 160/147, resample_multistage at 160/147 and
   resample_poly_kernel at 4/3; then stft_power_dft at 1024/256 on
   (16, 480000), the STFT 128/32 roundtrip on (16, 479232), istft_stockham
   at 1024/256 in both forms and stft_gate_packed at 1024/256 on the
   COLA-padded input, and STFT(1024, 256).spectrogram on (16, 480000);
   savgol_filter(x, 31, 3) on (16, 479232); and the calls the JAX package
   runs on XLA, which the port runs on the card by its "torch" route and
   which must launch no kernel: STFT(64, 16).process and power, an
   nfft-1000 spectrogram, complex input, reconstruct at 1024/384,
   SpectralGate at 128/128 and 128/24 (on a tone probe), MFCCFrontend at
   128/24 and a fused head under a plan budget where no layout fits, each
   held to its own CPU result on 2 channels;
   each path's launch counts equal to the
   kernels it must run, output shapes, finite values, float64 numpy/scipy
   oracles on 2 channels (SpectralGate on a probe input whose every bin
   lies far from the threshold, and the packed fused gate on the same
   probe), the staged chain against the fused one, the roundtrips and
   both inverses against their input; then the throughput of each row;
5. analysis and streaming: the tier the JAX package runs without a Pallas
   kernel, in plain PyTorch on the card, each path with the counters
   zeroed just before it and read just after, launching no kernel:
   iir_apply of butter_sos(4, 0.2) (the block state-space path) and of
   butter_sos(18, 0.2) (9 sections: the per-section scan), filtfilt_sos,
   lfilter at order 2 (one biquad scan) and 6, the IIR stream in blocks
   of 1,536, the analytic signal and the envelope on (16, 479232), the
   instantaneous frequency of a 1 kHz tone, the CZT at m = 4,096 on
   (16, 4096) and on the 479,232 samples cut into (1872, 4096) segments,
   a 512-point zoom CZT, cepstrum_real on (16, 4096), lpc(x, 16), and
   StreamingNorthStar() on (16, 491520) in blocks of 1,536, 6,144 and
   24,576 with its flush; then its offline composition (fir_apply ->
   resample_poly of the zero-led signal -> STFT(2048, 512).power -> mfcc),
   which launches the packed power kernel once. Each is held to float64
   scipy/numpy on 2 channels (the IIR at scipy's 3e-3, the analytic
   signal at 1e-4 absolute, the CZT at tests/test_czt.py's tolerances),
   the IIR stream and the streamed chain also to their offline forms on
   the card; a checkpoint of the stream's state saved half way and loaded
   back on the card must continue bit for bit. Each row prints its
   CUDA-event time, its wall time (a block's, for the streams), input-rate
   Msamples/s and the device's idle share under torch.profiler;
6. sharded: the sharded path (vv_dsp_tpu_torch.parallel) at full width on
   the (1, 8) and (2, 4) meshes of the card's devices repeated to 8
   shards, each path with the counters zeroed just before it and read
   just after: NorthStarChain.apply_sharded with fused and with staged
   halos and SpectralGate.apply_sharded (on the tone probe), each running
   the full-nfft spectrum kernel once a shard (c * b launches a call, no
   fallback), then fir_apply_sharded at 1,024 taps, iir_apply_sharded of
   butter_sos(4, 0.2), resample_poly_sharded at 4/3, savgol_filter_sharded
   (31, 3) and filtfilt_fir_sharded at 1,024 taps on (16, 479232), and
   hilbert_analytic_sharded and cepstrum_real_sharded on (16, 2^19), which
   launch none. Each is held to the dense port on the card (the chain at
   2e-3 of scale, fused against staged at 2e-4, tests/test_parallel.py's
   limits; the ops at the JAX suite's allclose tolerances), the chain also
   to its float64 oracle at 5e-5 of max|MFCC| and the gate to its float64
   oracle at 5e-5 of scale (2 channels). Each row prints its CUDA-event
   time, wall time, device busy time and idle share, and Msamples/s;
7. io: 16 seeded 16-bit mono WAVs of 479,232 samples written to a
   temporary directory under the checkout's build/, decoded in one batch
   by the native codec (csrc/wavio.cpp, built with g++) and by the numpy
   backend (bit-equal, and equal to the source's 16-bit quantization; the
   decode Msamples/s of both printed), moved to the card and fed to
   NorthStarChain, bit-equal to the chain on the clips read one by one
   ({upfirdn_banded: 1, stft_mfcc: 1}), and WAV -> SpectralGate ->
   write_wav -> read_wav ({stft_spectrum: 1, istft: 1}), equal to the
   16-bit quantization of the gate's output;
8. tools: the user surfaces. Each of the 12 CLI tools
   (vv_dsp_tpu_torch.tools) in this process on fixture files written from
   a seed, on the card and again with --cpu, the two held to each other
   at the CPU tests' limits (each launching no kernel: the tools run the
   plain entry points on cuFFT and elementwise ops), and bench_czt 4096
   4096 20 on the card (Peak bin: 37); the six example twins
   (vv_dsp_tpu_torch.examples) at their default sizes on the card, each
   with the counters zeroed just before it and read just after
   (SpectralGate's {stft_spectrum: 1, istft: 1}, MFCCFrontend's
   stft_mfcc, the sharded chain's stft_spectrum_stockham a shard), and
   again on the CPU, held to each other, each with its wall time; then
   utils.profiling: the chain's BenchResult beside cuda_ms,
   detect_chip() == "h100", a Chrome trace of one chain call, and the
   chain's FIR, STFT and resampler rooflines against those calls' times,
   each also against the section 6 bound of the same call;
9. multiprocess: the sharded set of phase 6 in several processes on the
   card, SPMD over one gloo group (vv_dsp_tpu_torch.parallel.comm: halos,
   the IIR's offsets and the block DFT's blocks cross processes through
   host memory): the (1, 8) mesh as 2 processes x 4 shards of cuda:0 and
   (2, 4) as 4 x 2 (each channel row split across two processes), every
   worker this script run as ``--mp-worker``. Each worker checks its own
   launches (kernel 9 once a shard it owns, a sharded STFT) and the last
   worker holds kernel 9 to its plain version on its own shards' blocks;
   each gathered output is held to phase 6's single-process result at
   the sharded limits, and each row prints its wall time a call from
   barrier to barrier (median of 5 after a warm-up) beside phase 6's
   event and wall times, and the bytes that crossed processes. Then
   ``vv_dsp_tpu_torch.tools.launch_multihost`` at N = 2 on the card at
   its defaults. A worker that fails or outlives its time limit fails the
   run.
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing neither, without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CHANNELS = 16
N_CHAIN = 479232
N_STFT = 480000
NFFT, HOP = 1024, 256          # the STFT row, the roundtrips and the gate
GATE_T = 0.1                   # SpectralGate's default threshold
REPS = 10
BATCH_BELOW_MS = 0.2
# H100 SXM peaks (NVIDIA's data sheet) for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# Limits, as fractions of the plain version's max |value| unless named
# otherwise; PERF.md gives the readings each was set from.
UPFIRDN_TOL = 1e-5      # same products, another float32 summation order
# float32 FFT noise in the log of low-energy mel bands: at f32 the plain
# version (cuFFT) sits 8.5e-4 and the kernel 4.1e-4 from a float64 oracle
# on this input, so the two differ by up to ~1.2e-3 (2.4e-6 of scale)
MFCC_TOL = 5e-6
SPECTRUM_TOL = 5e-5     # the FFT-class parity contract
POWER_TOL = 5e-5        # the FFT-class parity contract, of max power
# of max|y| on samples more than nfft from either end, and of the plain
# version's max |y * norm| before the norm (tests/test_pallas_fft.py's pin)
ISTFT_TOL = 5e-6
UPFIRDN_PROBE_TOL = 2.5e-7
MFCC_PROBE_TOL = 2.5e-6  # of sum_b |dct[q, b]| (|log mel_b| + 1)
ORACLE_TOL = 5e-5       # the reference's parity contract, of max |value|
ROUNDTRIP_TOL = 3e-5    # absolute, tests/test_pallas_fft.py's identity pin
# the full-nfft kernels: 5e-5 (the FFT-class contract) for the spectrum,
# power and mel energies, MFCC_TOL for MFCCs, and for the fused gate 5e-6 of
# scale on the samples SpectralGate keeps, at threshold 0 on dense input and
# at GATE_T on the tone probe (ISTFT_TOL's pin)
STOCKHAM_TOL = 5e-5
GATE_TOL = 5e-6
# a fused gate on dense input at GATE_T: a bin within float32 noise of the
# threshold may flip between the kernel's FFT and the plain version's, and
# one flip moves at most one frame's nfft samples; the readings are 0 and 1
# samples (PERF.md), a broken mask or peak moves millions. The full-nfft
# gate is held to its plain version run in float64, whose mask float32
# noise cannot flip: cuFFT's float32 spectrum flips bins lying within
# float32 noise of the level in frames where the kernel's mask is
# float64's (PERF.md)
GATE_FLIPS_FRAMES = 1
SMALL = (128, 32)              # the 128-point frames of the full-nfft paths
DENSE = (512, 8)               # the hop-8 spectrum row
# the filter and resample entry points (benchmarks/run_suite.py's rows):
# design_lowpass(taps, 0.3) filters, resample_poly's ratios on the input cut
# to a multiple of down
FIR_TAPS = (16, 64, 256, 1024)
RATIOS = ((2, 1), (1, 2), (4, 3), (160, 147))
# the direct FIR against fir_apply (cuDNN conv1d): the JAX package's FIR
# tolerance (tests/test_pallas.py:22); the per-phase resampler against
# resample_poly and float64 scipy: 1e-5, over 10x its readings (PERF.md)
FIR_TOL = 2e-5
POLY_TOL = 1e-5
# poly_kernel's rows on 16 channels, x cut to a multiple of down
POLY_RATIOS = ((4, 3), (2, 1), (1, 2), (3, 4), (7, 5))
ROWS = 65536            # rows_phase: one more than a launch's gridDim.y
STAGED_TOL = 1e-4       # staged against fused chain (tests/test_models.py)
# the windowed-DFT power against its plain version (tests/test_pallas.py's
# pin), of max power; the full-nfft inverse on samples more than nfft from
# either end (ISTFT_TOL) and on all samples (tests/test_pallas_fft.py's
# pins); the packed fused gate at threshold 0 returns its input to 3e-5
# absolute on the retained samples (tests/test_tpu_hardware.py's pin)
DFT_POWER_TOL = 1e-5
ISTFT_ALL_TOL = 1e-2
# savgol_filter's main-path window and order (the kernel path: the banded
# upfirdn at 1/1, offset wl - 1), the window lengths and the derivative it
# is also held at on 2 channels, and the filter tier's taps
SAVGOL = (31, 3)
SAVGOL_OTHERS = ((5, 3, 0), (101, 3, 0), (257, 3, 0), (31, 3, 1))
FILTER_TIER_TAPS = 1024
# the overlap-save FIR kernel against its plain version (the same segments
# and table through cuFFT), of max |y|; its taps sweep, at 16 and 64
# channels of N_CHAIN samples
OS_TOL = 1e-6
OS_SWEEP_TAPS = (128, 256, 512, 768, 1024, 1536, 2048)
# the core API on the card against its CPU result, as its CPU test holds
# it (tests/test_torch_core_api.py), of max |value|: the DCTs and the
# statistics 1e-5 (the excess kurtosis, near 0 on Gaussian input, 1e-5
# absolute), the frames equal, the overlap-add and phase unwrap 1e-6 and
# 1e-5 (a 479,232-sample cumulative sum), the FFT class 5e-5
CORE_TOL = 1e-5
# the analysis, IIR and streaming phase: plain PyTorch on the card (no
# kernel of the port, as the JAX package runs no Pallas kernel there). The
# streamed chain takes 491,520 samples a channel in blocks of 1,536, 6,144
# and 24,576 (benchmarks/bench_streaming.py); CZT rows at m = 4,096 on 16
# rows and on the 479,232 samples cut into 117 segments a channel
N_STREAM = 491520
STREAM_BLOCKS = (1536, 6144, 24576)
CZT_M = 4096
# against float64 scipy/numpy, of max |value| unless named otherwise: the
# IIR's scipy contract (tests/test_iir.py), a stream against the offline op
# (tests/test_streaming.py), the analytic signal 1e-4 absolute on
# unit-variance input (tests/test_hilbert.py), the CZT's rtol and atol (of
# max) on the DFT contour and on a zoom band (tests/test_czt.py), LPC at
# order 16 1e-4 (tests/test_torch_analysis.py), the streamed chain at rtol
# and atol 2e-3 against its offline composition (tests/test_streaming.py)
# and ORACLE_TOL against float64
IIR_TOL = 3e-3
IIR_STREAM_TOL = 2e-4
HILBERT_TOL = 1e-4
CZT_DFT_TOL = (1e-3, 2e-4)
CZT_ZOOM_TOL = (2e-3, 2e-3)
LPC_TOL = 1e-4
STREAM_TOL = 2e-3
# the plan budget under which no upfirdn layout fits a block (the least
# takes 1,296 bytes: a Hankel window of stride 8 at the bf16 tier): the
# fused head's "torch" route, which no geometry of realistic size reaches
# at the card's 232,448 bytes
REFUSING_BUDGET = 1024
# the sharded phase: the (1, 8) and (2, 4) meshes of the card's devices
# repeated to 8 shards; Hilbert and the cepstrum on (16, 2^19). Limits:
# tests/test_parallel.py's, the chain's of scale, the ops' as allclose
# rtol = atol on unit-variance input
SHARDS = 8
SHARD_MESHES = ((1, 8), (2, 4))
N_LONG = 1 << 19
SHARDED_CHAIN_TOL = 2e-3
FUSED_STAGED_TOL = 2e-4
SHARDED_FIR_TOL = 2e-5
SHARDED_IIR_TOL = 1e-4
SHARDED_RESAMPLE_TOL = 2e-4    # resample_poly and savgol
SHARDED_FILTFILT_TOL = 5e-4
SHARDED_FFT_TOL = 1e-3         # Hilbert and the cepstrum
N_WAV = 16                     # the I/O phase's clips
# the multi-process phase: (mesh, processes, shards a process) on cuda:0
MP_LAYOUTS = (((1, 8), 2, 4), ((2, 4), 4, 2))
MP_REPS = 5
MP_TIMEOUT_S = 300             # a worker's life, and its group's timeout
# the tools phase: each CLI tool on the card against its --cpu run, at the
# CPU tests' limits (tests/test_torch_tools.py): 5e-5 of the larger
# max |value| for the FFT class (dump_stft_roundtrip before its w^2 norm),
# 1e-5 for the filters and resamplers; each example twin at its default
# size on the card against its CPU run, at the limits of the port's tests
# of its calls (tests/test_torch_examples.py): SpectralGate 5e-5 of scale
# (the FFT class: the tone clears the threshold in every frame), MFCCs
# 5e-4 absolute or MFCC_TOL of scale, whichever is larger
# (tests/test_torch_cuda.py), also wav_mfcc's c0 mean, whose MFCCs (two
# tones over 16-bit quantization noise, bands 1e-11 of the peak) are held
# within twice the CPU run's own distance from float64 (PERF.md), the
# filters 1e-5 of max |y|, the sharded FIR
# and IIR 2e-5 and 1e-4 from dense; the precision tiers' errors against
# "highest" under 1e-6 (highest), 1e-4 (bf16x3), 1e-2 (bf16)
TOOL_FFT_TOL = 5e-5
TOOL_FILTER_TOL = 1e-5
MFCC_ATOL = 5e-4
TIER_BOUNDS = {"highest": 1e-6, "high": 1e-4, "default": 1e-2}
BENCH_CZT = ("4096", "4096", "20")
# each example twin's kernel launches at its default size
EXAMPLE_LAUNCHES = {"stft_pipeline": {"stft_spectrum": 1, "istft": 1},
                    "wav_mfcc": {"stft_mfcc": 1},
                    "serving": {"stft_mfcc": 5},    # 4 batches + warm-up
                    "filter": {},
                    "precision": {"stft_mfcc": 4},
                    "multichip": {"stft_spectrum_stockham": 8}}


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    print(smi)
    return card


def import_port():
    """The port package of this checkout (not an installed copy)."""
    sys.path.insert(0, HERE)
    import vv_dsp_tpu_torch
    pkg = os.path.dirname(os.path.abspath(vv_dsp_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise SystemExit(f"chip_smoke: vv_dsp_tpu_torch at {pkg} is not "
                         f"this checkout's")
    return vv_dsp_tpu_torch


def build_phase() -> list[str]:
    """Build the kernels; returns build.log's lines (ptxas -v)."""
    from vv_dsp_tpu_torch import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.1f} s -> {os.path.relpath(lib_path, HERE)}")
    log = (lib_path.parent / "build.log").read_text().splitlines()
    for line in log:
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    spills = checked_spills(log)
    if spills:
        raise SystemExit(f"chip_smoke: kernel instances spill: {spills}")
    return log


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of one fn() call on the current stream (CUDA
    events), after two warm-up calls. A call shorter than BATCH_BELOW_MS
    is timed as a run of back-to-back calls of about 2 ms over their
    count, so that the host's time to launch it is not read as device
    time."""
    def run(calls: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    for _ in range(2):
        fn()
    once = run(1)
    calls = 1 if once >= BATCH_BELOW_MS else min(200, math.ceil(2.0 / once))
    return statistics.median(run(calls) for _ in range(reps))


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that as a fraction of max |want|)."""
    err = (got - want).abs().max().item()
    return err, err / want.abs().max().item()


def bound(nbytes: float, flops: float, flop_rate: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return {"bound_ms": float(max(t_bytes, t_ops)),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ptxas_of(log: list[str], tag: str) -> dict:
    """Registers, spill stores and static shared memory of the entry
    function whose mangled name contains tag, as build.log (nvcc -Xptxas
    -v) gives them; {} if there is none."""
    found, got = False, {}
    for line in log:
        if "Compiling entry function" in line:
            if found:
                break
            found = tag in line
        elif found:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill stores", r"(\d+) bytes spill stores"),
                             ("static smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    got[key] = int(m.group(1))
    return got if found else {}


def usage_text(log: list[str], tag: str) -> str:
    got = ptxas_of(log, tag)
    if not got:
        return f"{tag}: not in build.log"
    return (f"{got.get('registers')} registers, "
            f"{got.get('spill stores')} bytes spill stores, "
            f"{got.get('static smem', 0)} bytes static shared memory")


def ptxas_usage(log: list[str], kernel: str, n: int, onesided: bool,
                lead: bool | None = None) -> str:
    """ptxas's figures of one instance of a spectrum kernel template
    <N, ONESIDED>, or <N, ONESIDED, LEAD> where lead is given."""
    tag = f"{kernel}ILi{n}ELb{int(onesided)}E"
    if lead is not None:
        tag += f"Lb{int(lead)}E"
    return usage_text(log, tag)


# kernels whose instances may not spill: the two tensor-core kernels
# (csrc/upfirdn.cu, csrc/dft_power.cu), the packed MFCC and power kernels
# (csrc/stft.cu), the full-nfft inverse, fused gate, mel/MFCC and power
# kernels (csrc/stockham.cu), the packed inverse and the packed fused gate
# (csrc/istft.cu, csrc/gate_packed.cu), the per-phase resampler
# (csrc/filter.cu), the overlap-save FIR (csrc/fir_os.cu)
NO_SPILL = ("upfirdn_mma_kernel", "dft_power_kernel", "stft_mfcc_kernel",
            "istft_stockham_kernel", "istft_kernel",
            "stft_gate_packed_kernel", "stockham_gate_kernel",
            "stockham_mel_kernel", "stft_power_kernel",
            "stockham_power_kernel", "poly_kernel", "fir_os_kernel")


def kernel_name(mangled: str) -> str:
    """The function name of an Itanium-mangled entry function
    (_Z17stft_power_kernelILi512EE... -> stft_power_kernel)."""
    m = re.match(r"_Z(\d+)", mangled)
    return mangled[m.end():m.end() + int(m.group(1))] if m else mangled


def checked_spills(log: list[str]) -> list[str]:
    """Instances of the NO_SPILL kernels that spill, by mangled name; a
    kernel is matched by its exact name, not a part of it."""
    spills, name = [], None
    for line in log:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and kernel_name(name) in NO_SPILL:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and int(m.group(1)):
                spills.append(name)
    return spills


def redesign_line(name, label, r, log, kernel, n, onesided, smem,
                  lead=None) -> None:
    """The redesigned spectrum kernels' row: kernel, torch.stft and bound
    ms, the bound's share of the kernel time, and what ptxas gave it (the
    instance without LEAD where lead is False)."""
    print(f"  redesign {name} [{label}]: kernel {r['ms']:.4f} ms, torch.stft "
          f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x), "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share of the "
          f"bound {r['bound_ms'] / r['ms']:.3f}; build.log: "
          f"{ptxas_usage(log, kernel, n, onesided, lead)}; dynamic shared "
          f"memory "
          f"{smem} bytes a block (the launcher's request)")


def power_line(name, label, r, stft_ms, log, kernel, n, smem) -> None:
    """A power kernel's redesign line, with the one-sided spectrum kernel's
    time at the same geometry (r["spectrum_ms"]), the yardstick that stands
    in for the missing library call, the registers of every instance of
    the kernel, and torch.stft followed by abs().square() on the same input
    as a reference (not the row's library time)."""
    mma_line(name, label, r["ms"], r["bound_ms"], r["bound_by"], log,
             f"{kernel}ILi{n}EE", smem, kind="redesign")
    print(f"  {name} [{label}]: the one-sided spectrum kernel at the same "
          f"geometry {r['spectrum_ms']:.4f} ms (power {r['ms']:.4f} ms, "
          f"{r['ms'] / r['spectrum_ms']:.2f}x); torch.stft + abs().square() "
          f"{stft_ms:.4f} ms, a reference: library call none (torch.stft "
          f"writes the complex spectrum; the power takes another pass)")
    sizes = (128, 256, 512, 1024, 2048)
    print(f"  {kernel} instances: " + instance_registers(
        log, {f"<{m}>": f"{kernel}ILi{m}EE" for m in sizes}))


def upfirdn_instance(up, down, taps_pp, offset, tier) -> tuple[str, int]:
    """The csrc/upfirdn.cu instance <ALG, NT, MT, FLUSH> a launch runs, as
    its mangled-name tag, and its dynamic shared memory: the host plan's
    (ops/mma_plan.py upfirdn_plan), which the launcher follows."""
    from vv_dsp_tpu_torch import config
    from vv_dsp_tpu_torch.ops import mma_plan as mp
    p = mp.upfirdn_plan(up, down, taps_pp, offset, tier)
    tag = (f"upfirdn_mma_kernelILi{config.ALGORITHMS.index(tier)}"
           f"ELi{p.n_tiles}ELi{p.m_tiles}ELb{int(p.flush > 0)}E")
    return tag, p.smem


def mma_line(name, label, ms, bound_ms, bound_by, log, tag, smem,
             kind="tensor cores") -> None:
    """A redesigned kernel's row (the tensor-core kernels', and with kind
    "redesign" those on the register-resident FFT): kernel and bound ms,
    the bound's share of the kernel time, and what ptxas gave the
    instance."""
    print(f"  {kind} {name} [{label}]: kernel {ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), share of the bound "
          f"{bound_ms / ms:.3f}; build.log: {usage_text(log, tag)}; "
          f"dynamic shared memory {smem} bytes a block")


def mfcc_instance(mfcc_args, tier) -> tuple[str, int]:
    """The csrc/stft.cu instance <M, ALG, FUSE_DCT> an stft_mfcc launch
    with the DCT runs, as its mangled-name tag, and its dynamic shared
    memory: the host plan's (ops/fft_plan.py mfcc_plan), which the
    launcher checks."""
    from vv_dsp_tpu_torch import config
    from vv_dsp_tpu_torch.ops import fft_plan
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    nfft, _, _, mel_fb, bands, dct = mfcc_args[:6]
    weights, _ = sk._mel_tables(mel_fb, bands)
    plan = fft_plan.mfcc_plan(nfft, mel_fb.shape[0], dct.shape[0],
                              weights.numel(), True)
    return (f"stft_mfcc_kernelILi{nfft // 2}ELi"
            f"{config.ALGORITHMS.index(tier)}ELb1E", plan.smem)


def instance_registers(log: list[str], tags: dict) -> str:
    """Registers and spill stores of each named instance, from build.log."""
    parts = []
    for name, tag in tags.items():
        got = ptxas_of(log, tag)
        parts.append(f"{name} {got.get('registers')} registers, "
                     f"{got.get('spill stores')} B spilled")
    return "; ".join(parts)


def stockham_mel_instance(front) -> tuple[str, int]:
    """The csrc/stockham.cu instance <N, FUSE_DCT> an MFCCFrontend on the
    full-nfft route runs, as its mangled-name tag, and its dynamic shared
    memory: the host plan's (ops/fft_plan.py stockham_mel_plan), which the
    launcher checks."""
    from vv_dsp_tpu_torch.ops import fft_plan
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    weights, _ = sk._mel_tables(front.mel_fb, front.mel_bands)
    plan = fft_plan.stockham_mel_plan(front.nfft, front.mel_fb.shape[0],
                                      front.dct_lift.shape[0],
                                      weights.numel(), True)
    return f"stockham_mel_kernelILi{front.nfft}ELb1EE", plan.smem


def fr_smem(n: int, packed: bool) -> int:
    """Dynamic shared memory of a register-resident spectrum block: the
    twiddle table, wk (packed) and two exchange buffers of 2048 points."""
    from vv_dsp_tpu_torch.ops import fft_plan
    return 8 * (fft_plan.pass_offsets(n)[-1] + (n + 1 if packed else 0)
                + 2 * 2048)


def fft_flops(frames: int, nfft: int) -> float:
    """Operations of one real nfft-point FFT per frame (2.5 N log2 N)."""
    return frames * 2.5 * nfft * np.log2(nfft)


def os_flops(c: int, n: int, taps: int) -> float:
    """Operations of the overlap-save kernel: per segment two complex
    FFTs of M = 2,048 points (5 M log2 M each) and the table's two complex
    products and sum a bin (14 M)."""
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    m = fk.OS_NFFT // 2
    segs = c * -(-n // fk.os_geometry(taps)[1])
    return segs * (2 * 5 * m * np.log2(m) + 14 * m)


def mel_bound(x, out, front) -> dict:
    """The fused STFT -> mel -> log -> DCT front end's bound: the signal
    read and the features written once; per frame a real FFT, the powers,
    the mel products over the filterbank's nonzero weights and the DCT."""
    nfft, n_mels = front.nfft, front.mel_fb.shape[0]
    frames = out.shape[0] * out.shape[1]
    return bound(4 * (x.numel() + out.numel()),
                 fft_flops(frames, nfft) + frames * (
                     3 * (nfft // 2 + 1) + 2 * int((front.mel_fb != 0).sum())
                     + 2 * n_mels * out.shape[2]), F32_FLOP_PER_S)


def impulses(n: int, period: int, first: int, seed: int) -> torch.Tensor:
    """(CHANNELS, n) zeros with N(0, 1) impulses at first + i*period."""
    x = np.zeros((CHANNELS, n), np.float32)
    pos = np.arange(first, n, period)
    x[:, pos] = np.random.default_rng(seed).standard_normal(
        (CHANNELS, len(pos)))
    return torch.as_tensor(x, device="cuda")


def tier_probes(head, mfcc_args, failed: list) -> None:
    """Tier identity, at the main path's shapes. On the dense input the
    tiers' gap is of the size of float32 summation (upfirdn) or FFT (MFCC)
    noise, so it cannot show which tier a kernel computed. These inputs make
    the two versions form the same products at one tier:
    - upfirdn: one impulse per 1500 samples, more than the 1044 taps of a
      phase, so every output is a single product;
    - MFCC: one impulse per 2048 samples, so every 2048-sample frame holds
      one impulse and has a flat power spectrum (no low-energy bins).
    Each same-tier pair must agree within the probe's limit, and each
    control (a kernel tier held against another plain tier) must not."""
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import upfirdn as uf

    def judge(name, k_tier, p_tier, reading, limit, unit):
        control = k_tier != p_tier
        ok = (reading >= limit) if control else (reading < limit)
        kind = "control" if control else "check"
        print(f"tier probe {name} {kind}: kernel {k_tier} vs plain {p_tier}: "
              f"{reading:.3e} {unit} (limit {limit:g}; "
              f"{'must exceed' if control else 'must stay below'}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} tier probe, kernel {k_tier} vs plain "
                          f"{p_tier}")

    up, down, offset, n_out, taps = head
    xp = impulses(N_CHAIN, 1500, 700, 1)
    pairs = [("f32", "f32"), ("bf16x3", "bf16x3"), ("bf16", "bf16"),
             ("f32", "bf16x3")]
    for k_tier, p_tier in pairs:
        got = uf.upfirdn_banded(xp, taps, up, down, offset, n_out, k_tier)
        want = uf.upfirdn_tall(xp, taps, up, down, offset, n_out, p_tier)
        judge("upfirdn_banded", k_tier, p_tier, rel_err(got, want)[1],
              UPFIRDN_PROBE_TOL, "of max|y|")

    nfft, hop, window, mel_fb, _, dct, log_eps = mfcc_args
    plain_args = (nfft, hop, window, mel_fb, dct, log_eps)
    yp = impulses(n_out, nfft, nfft // 2, 2)
    mel = sk.stft_mfcc_plain(yp, nfft, hop, window, mel_fb, None, log_eps,
                             "f32")
    # each element's scale: sum_b |dct[q, b]| (|log mel_b| + 1)
    scale = (torch.log(mel + log_eps).abs() + 1) @ dct.abs().T
    pairs = [("f32", "f32"), ("bf16x3", "bf16x3"), ("f32", "bf16x3"),
             ("bf16", "f32")]
    for k_tier, p_tier in pairs:
        got = sk.stft_mfcc(yp, *mfcc_args, k_tier)
        want = sk.stft_mfcc_plain(yp, *plain_args, p_tier)
        reading = ((got - want).abs() / scale).max().item()
        judge("stft_mfcc", k_tier, p_tier, reading, MFCC_PROBE_TOL,
              "of the element's scale")


def record(name, label, got, want, tol, fast, plain, failed: list,
           edge: int = 0) -> dict:
    """A kernel against its plain version as a fraction of the plain
    version's max |value| (on samples more than `edge` from either end),
    with both times."""
    if edge:
        got, want = got[..., edge:-edge], want[..., edge:-edge]
    err, rel = rel_err(got, want)
    ok = rel < tol
    ms, plain_ms = cuda_ms(fast), cuda_ms(plain)
    torch.cuda.synchronize()
    where = f" more than {edge} samples from the ends" if edge else ""
    print(f"kernel {name} [{label}]: max_abs_err {err:.3e}, {rel:.3e} of "
          f"scale{where} (tol {tol:g}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append(f"{name} [{label}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def edge_pad_row(xc, failed: list, log: list[str]) -> dict:
    """SpectralGate's one-sided spectrum of its edge-padded rows: the
    kernel's LEAD instance reading the pad in place beside the kernel on
    F.pad's padded copy (the copy's fill and write timed with it), which
    must give the same bits, and the LEAD instance's ptxas figures."""
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops.stft import STFT

    pad = NFFT - HOP
    win = STFT(NFFT, HOP).win(xc.device)
    lead = lambda: sk.stft_spectrum(xc, NFFT, HOP, win, True, pad=pad)
    padded = lambda: sk.stft_spectrum(
        torch.nn.functional.pad(xc, (pad, pad)), NFFT, HOP, win, True)
    same = torch.equal(torch.view_as_real(lead()).view(torch.int32),
                       torch.view_as_real(padded()).view(torch.int32))
    lead_ms, padded_ms = cuda_ms(lead), cuda_ms(padded)
    print(f"  stft_spectrum [{NFFT}/{HOP} one-sided, edge pad {pad} on "
          f"{tuple(xc.shape)}]: LEAD instance {lead_ms:.4f} ms, F.pad + "
          f"kernel {padded_ms:.4f} ms ({padded_ms / lead_ms:.2f}x), "
          f"bit-identical {same}; build.log: "
          f"{ptxas_usage(log, 'stft_spectrum_kernel', NFFT // 2, True, True)}")
    if not same:
        failed.append(f"stft_spectrum [edge pad {pad}]")
    return {"edge_pad_ms": lead_ms, "edge_pad_padded_ms": padded_ms}


def kernel_phase(xc, xs, chain, front, front128, log: list[str]) -> dict:
    """Each kernel against its plain version at the main path's shapes
    (the MFCC kernel at the chain's and at MFCCFrontend's geometry)."""
    from vv_dsp_tpu_torch.ops import mma_plan as mp
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import upfirdn as uf
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np
    from vv_dsp_tpu_torch.ops.stft import STFT

    gcd = np.gcd(chain.up, chain.down)
    up, down = chain.up // gcd, chain.down // gcd
    h = np.asarray(chain.fir_coeffs, np.float64)
    _, offset = rs._fused_fir_resample_filter(tuple(h), up, down)
    n_out = -(-N_CHAIN * up // down)
    taps = chain.head_taps
    results, failed = {}, []

    def tier_gap(name, got, want, p_tier):
        print(f"  dense-input tier gap, not a check: {name} kernel vs plain "
              f"{p_tier}: {rel_err(got, want)[1]:.3e} of scale")

    # each tier's bound: its bf16 products (1, 3 or 6 a tap) at the tensor
    # cores' rate; f32 also as float32 FMAs on the CUDA cores, the lesser
    # of the two bounding it
    c = xc.shape[0]
    io = 4 * (xc.numel() + c * n_out + taps.numel())
    macs = c * n_out * taps.shape[1]
    tier_bounds = {
        "f32": min((bound(io, 2 * macs, F32_FLOP_PER_S),
                    bound(io, 6 * 2 * macs, BF16_FLOP_PER_S)),
                   key=lambda b: b["bound_ms"]),
        "bf16x3": bound(io, 3 * 2 * macs, BF16_FLOP_PER_S),
        "bf16": bound(io, 2 * macs, BF16_FLOP_PER_S)}
    tier_ms = {}
    for tier in ("f32", "bf16x3", "bf16"):
        fast = lambda: uf.upfirdn_banded(xc, taps, up, down, offset, n_out,
                                         tier)
        plain = lambda: uf.upfirdn_tall(xc, taps, up, down, offset, n_out,
                                        tier)
        got = fast()
        r = record("upfirdn_banded", tier, got, plain(), UPFIRDN_TOL, fast,
                   plain, failed)
        tier_ms[tier] = r["ms"]
        b = tier_bounds[tier]
        mma_line("upfirdn_banded", f"chain head, {tier}", r["ms"],
                 b["bound_ms"], b["bound_by"], log,
                 *upfirdn_instance(up, down, taps.shape[1], offset, tier))
        if tier == "f32":
            tier_gap("upfirdn_banded f32", got,
                     uf.upfirdn_tall(xc, taps, up, down, offset, n_out,
                                     "bf16x3"), "bf16x3")
        if tier == chain.head_algorithm:
            results["upfirdn_banded"] = r
    results["upfirdn_banded"].update(tier_bounds[chain.head_algorithm])
    results["upfirdn_banded"].update(
        {f"{t}_ms": v for t, v in tier_ms.items()})
    results["upfirdn_banded"].update(
        {f"{t}_bound_ms": b["bound_ms"] for t, b in tier_bounds.items()})
    print("  upfirdn_banded at the chain head: "
          + "; ".join(f"{t} {tier_ms[t]:.4f} ms against a "
                      f"{tier_bounds[t]['bound_ms']:.4f} ms bound"
                      for t in tier_ms)
          + f" (the kernels line carries {chain.head_algorithm}, the "
          f"chain's tier; most launches run f32)")
    results["upfirdn_banded"]["library_ms"] = None
    print("  upfirdn_banded library call: none (no single PyTorch call "
          "computes a polyphase upfirdn; conv1d would need the signal "
          "zero-stuffed first)")
    # the layouts the chain head does not take, on 2 x 48000: B's slice cut
    # into column blocks (the fused head at 8/7), streamed in depth chunks
    # (16,384 taps) and A's rows copied (1/1000); the plain version in
    # frames of 8 where its own would hold a taps_pp-squared matrix
    x2 = xc[:2, :48000].contiguous()
    g87, off87 = rs._fused_fir_resample_filter(tuple(h), 8, 7)
    for label, g, u, d, off, tier, group in (
            ("fused head 8/7", g87, 8, 7, off87, "bf16x3", None),
            ("16384 taps 1/1", design_lowpass_np(16384, 0.3), 1, 1, 0,
             "f32", 8),
            ("21 taps 1/1000", design_lowpass_np(21, 0.0009), 1, 1000, 10,
             "f32", None)):
        tab = uf.polyphase_table(g, u, xc.device)
        n2 = -(-x2.shape[1] * u // d)
        fast = lambda: uf.upfirdn_banded(x2, tab, u, d, off, n2, tier)
        plain = lambda: uf.upfirdn_tall(x2, tab, u, d, off, n2, tier, group)
        p = mp.upfirdn_plan(u, d, tab.shape[1], off, tier)
        record("upfirdn_banded", f"{label}, {tier}, 2 x 48000: "
               f"{p.col_blocks} column blocks, {p.k_pad // p.k_chunk} "
               f"depth chunks, A pitch {p.a_pitch}, flush {p.flush}",
               fast(), plain(), UPFIRDN_TOL, fast, plain, failed)
    y = uf.upfirdn_banded(xc, taps, up, down, offset, n_out, "f32")
    mfcc_args = (chain.nfft, chain.hop, chain.window, chain.mel_fb,
                 chain.mel_bands, chain.dct_lift, 1e-10)
    plain_args = mfcc_args[:4] + mfcc_args[5:]
    for tier in ("f32", "bf16x3"):
        fast = lambda: sk.stft_mfcc(y, *mfcc_args, tier)
        plain = lambda: sk.stft_mfcc_plain(y, *plain_args, tier)
        got = fast()
        r = record("stft_mfcc", tier, got, plain(), MFCC_TOL, fast, plain,
                   failed)
        b = mel_bound(y, got, chain)
        mma_line("stft_mfcc", f"chain, {tier}", r["ms"], b["bound_ms"],
                 b["bound_by"], log, *mfcc_instance(mfcc_args, tier),
                 kind="redesign")
        if tier == "f32":
            tier_gap("stft_mfcc f32", got,
                     sk.stft_mfcc_plain(y, *plain_args, "bf16x3"), "bf16x3")
        if tier == chain.stft_algorithm:
            results["stft_mfcc"] = r
    tier_gap("stft_mfcc bf16", sk.stft_mfcc(y, *mfcc_args, "bf16"),
             sk.stft_mfcc_plain(y, *plain_args, "f32"), "f32")
    results["stft_mfcc"].update(mel_bound(y, got, chain))
    results["stft_mfcc"]["library_ms"] = None
    print("  stft_mfcc library call: none (no single PyTorch call computes "
          "STFT -> mel -> log -> DCT)")
    # MFCCFrontend's geometry (1024/256, 26 mels, 13 MFCCs, f32) on xc
    front_args = (front.nfft, front.hop, front.window, front.mel_fb,
                  front.mel_bands, front.dct_lift, 1e-10, "f32")
    front_plain = front_args[:4] + front_args[5:]
    fast = lambda: sk.stft_mfcc(xc, *front_args)
    plain = lambda: sk.stft_mfcc_plain(xc, *front_plain)
    got = fast()
    r = record("stft_mfcc", "MFCCFrontend f32", got, plain(), MFCC_TOL,
               fast, plain, failed)
    r.update(mel_bound(xc, got, front))
    mma_line("stft_mfcc", "MFCCFrontend f32", r["ms"], r["bound_ms"],
             r["bound_by"], log, *mfcc_instance(front_args, "f32"),
             kind="redesign")
    results["stft_mfcc"].update({f"frontend_{k}": v for k, v in r.items()})

    win = STFT(NFFT, HOP).win(xs.device)
    for onesided in (False, True):
        fast = lambda: sk.stft_spectrum(xs, NFFT, HOP, win, onesided)
        plain = lambda: sk.stft_spectrum_plain(xs, NFFT, HOP, win, onesided)
        got = fast()
        r = record("stft_spectrum", "onesided" if onesided else "two-sided",
                   got, plain(), SPECTRUM_TOL, fast, plain, failed)
        # torch.stft drops the zero-padded tail frame, so it gets the
        # signal padded by hop (outside the timed call); it writes
        # (c, bins, frames)
        xs_pad = torch.nn.functional.pad(xs, (0, HOP))
        lib = lambda: torch.stft(xs_pad, NFFT, HOP, window=win, center=False,
                                 onesided=onesided, return_complex=True)
        assert lib().shape == (c, got.shape[2], got.shape[1])
        r["library_ms"] = cuda_ms(lib)
        r.update(bound(4 * xs.numel() + 8 * got.numel(),
                       fft_flops(c * got.shape[1], NFFT), F32_FLOP_PER_S))
        print(f"  torch.stft (layout c, bins, frames): "
              f"{r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        redesign_line("stft_spectrum", f"{NFFT}/{HOP} "
                      f"{'one' if onesided else 'two'}-sided", r, log,
                      "stft_spectrum_kernel", NFFT // 2, onesided,
                      fr_smem(NFFT // 2, True), lead=False)
        if not onesided:
            results["stft_spectrum"] = r
        else:
            results["stft_spectrum"].update(
                {f"onesided_{k}": v for k, v in r.items()})
    results["stft_spectrum"].update(edge_pad_row(xc, failed, log))
    # the ends of the packed kernel's range, N = 128 and 2048, on 2 channels
    for nfft, hop in ((256, 64), (4096, 1024)):
        w = STFT(nfft, hop).win(xs.device)
        for onesided in (False, True):
            fast = lambda: sk.stft_spectrum(xs[:2], nfft, hop, w, onesided)
            plain = lambda: sk.stft_spectrum_plain(xs[:2], nfft, hop, w,
                                                   onesided)
            record("stft_spectrum", f"{nfft}/{hop} "
                   f"{'one' if onesided else 'two'}-sided, 2 ch", fast(),
                   plain(), SPECTRUM_TOL, fast, plain, failed)

    fast = lambda: sk.stft_power(xs, NFFT, HOP, win)
    plain = lambda: sk.stft_power_plain(xs, NFFT, HOP, win)
    got = fast()
    r = record("stft_power", f"{NFFT}/{HOP}", got, plain(), POWER_TOL, fast,
               plain, failed)
    r.update(bound(4 * (xs.numel() + got.numel()),
                   fft_flops(c * got.shape[1], NFFT), F32_FLOP_PER_S))
    r["library_ms"] = None
    r["spectrum_ms"] = results["stft_spectrum"]["onesided_ms"]
    lib = lambda: torch.stft(xs_pad, NFFT, HOP, window=win, center=False,
                             return_complex=True).abs().square()
    power_line("stft_power", f"{NFFT}/{HOP}", r, cuda_ms(lib), log,
               "stft_power_kernel", NFFT // 2, fr_smem(NFFT // 2, True))
    results["stft_power"] = r

    results.update(istft_phase(xc, win, failed, log))
    results.update(stockham_phase(xc, xs, front128, failed, log))
    results.update(filter_phase(xc, failed, log))
    results["fir_os"] = fir_os_phase(xc, failed, log)
    results["upfirdn_banded"].update(core_phase(xc, failed, log))
    results["stft_power_dft"] = dft_power_phase(xs, win, failed, log)
    results["istft_stockham"] = istft_stockham_phase(xc, win, failed, log)
    results["stft_gate_packed"] = gate_packed_phase(xc, win, failed, log)
    rows_phase(failed)
    tier_probes((up, down, offset, n_out, taps), mfcc_args, failed)
    torch.cuda.synchronize()
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failed}")
    return results


def istft_phase(xc, win, failed: list, log: list[str]) -> dict:
    """The inverse kernel on SpectralGate's shape: the one-sided spectrum
    of the COLA-padded (16, 479232) input, (16, 1876, 513), back to
    (16, 480768) samples; without the gate (STFT.reconstruct) and with it
    (SpectralGate). The plain version is fed the kernel's own forward
    spectrum, so both gate the same bins. A redesign line for each: the
    <M, GATE> instance's ptxas figures and the plan's shared memory."""
    from vv_dsp_tpu_torch.ops import fft_plan
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops.window import get_window_np

    xp = torch.nn.functional.pad(xc, (NFFT - HOP, NFFT - HOP))
    c, n_pad = xp.shape
    spec = sk.stft_spectrum(xp, NFFT, HOP, win, True)
    nf = spec.shape[1]
    norm = ik.ola_norm(get_window_np("hann", NFFT), HOP, nf, n_pad, xp.device)
    out = {}
    for gate in (None, GATE_T):
        fast = lambda: ik.istft(spec, NFFT, HOP, n_pad, win, norm, gate)
        plain = lambda: ik.istft_plain(spec, NFFT, HOP, n_pad, win, norm, gate)
        got, want = fast(), plain()
        label = "no gate" if gate is None else f"gate {gate:g}"
        pre_rel = rel_err(got * norm, want * norm)[1]
        print(f"  istft [{label}] before the norm, full length: "
              f"{pre_rel:.3e} of scale (tol {ISTFT_TOL:g}) "
              f"{'ok' if pre_rel < ISTFT_TOL else 'FAIL'}")
        if not pre_rel < ISTFT_TOL:
            failed.append(f"istft [{label}] before the norm")
        if not torch.equal(got, fast()):
            failed.append(f"istft [{label}] differs between two runs")
        r = record("istft", label, got, want, ISTFT_TOL, fast, plain, failed,
                   edge=NFFT)
        out["istft" if gate is None else "istft_gated"] = r
        if gate is None:
            ungated = got
    p2 = spec.real * spec.real + spec.imag * spec.imag
    level = GATE_T ** 2 * p2.amax(-1, keepdim=True)
    near = int((((p2 - level).abs() <= 1e-5 * level) & (level > 0)).sum())
    print(f"  dense-input bins within 1e-5 (relative) of the gate's "
          f"threshold (frames of zeros left out): {near} of {p2.numel()}")
    r = out["istft"]
    r.update(bound(8 * spec.numel() + 4 * (c * n_pad + n_pad),
                   fft_flops(c * nf, NFFT) + c * nf * 2 * NFFT,
                   F32_FLOP_PER_S))
    for gate, ms in ((0, r["ms"]), (1, out["istft_gated"]["ms"])):
        mma_line("istft", "gate 0.1" if gate else "no gate", ms,
                 r["bound_ms"], r["bound_by"], log,
                 f"istft_kernelILi{NFFT // 2}ELb{gate}E",
                 fft_plan.packed_istft_smem(NFFT, HOP), kind="redesign")
    r["gated_ms"] = out.pop("istft_gated")["ms"]
    groups = fft_plan.istft_groups(c, nf, NFFT, HOP, n_pad)
    for gate in (None, GATE_T):
        ik.ring_tally(xp.device, reset=True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            ik.istft(spec, NFFT, HOP, n_pad, win, norm, gate)
        t = ik.ring_tally(xp.device, reset=True)
        label = "no gate" if gate is None else f"gate {gate:g}"
        ok = (t["launches"] == 1 and t["groups"] == groups
              and 0 <= t["ready"] <= groups)
        share = t["ready"] / max(t["groups"], 1)
        print(f"  istft ring [{label}]: {t['ready']} of {t['groups']} groups "
              f"landed when first tested ({share:.4f}; the walk has "
              f"{groups}), kernel {r['ms' if gate is None else 'gated_ms']:.4f}"
              f" ms {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"istft ring tally [{label}]: {t}")
        r["ring_ready_share" + ("" if gate is None else "_gated")] = share
    try:
        lib = lambda: torch.istft(spec.transpose(1, 2), NFFT, HOP, window=win,
                                  center=False, length=n_pad)
        y = lib()
    except RuntimeError as e:
        r["library_ms"] = None
        print(f"  istft library call: none, torch.istft refuses: "
              f"{str(e).splitlines()[0][:200]}")
    else:
        r["library_ms"] = cuda_ms(lib)
        err = rel_err(y[:, NFFT:-NFFT], ungated[:, NFFT:-NFFT])[1]
        print(f"  torch.istft: {r['library_ms']:.4f} ms, {err:.3e} of scale "
              f"from the kernel on the interior")
    print(f"  istft bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


def stockham_phase(xc, xs, front128, failed: list, log: list[str]) -> dict:
    """The full-nfft kernels against their plain versions: power, mel/MFCC
    and the fused gate at 128/32 on (16, 479232), the spectrum at 512/8 on
    (16, 480000) (the shapes their entry points give them), and each at one
    geometry of the other kind on 2 channels."""
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.ops.mel import _mel_constants
    from vv_dsp_tpu_torch.ops.stft import STFT

    def io(got, x) -> str:
        return (f"2 ch: {4 * x.numel() / 1e6:.2f} MB in, "
                f"{got.element_size() * got.numel() / 1e6:.2f} MB out")

    out = {}
    c, dev = xc.shape[0], xc.device
    x2 = xs[:2]                  # 2 x 480000 samples, 3.84 MB
    win128, win1024 = STFT(*SMALL).win(dev), STFT(1024, 8).win(dev)

    def power_row(x, nfft, hop, w, label):
        fast = lambda: stk.stft_power_stockham(x, nfft, hop, w)
        plain = lambda: stk.stft_power_stockham_plain(x, nfft, hop, w)
        got = fast()
        r = record("stft_power_stockham", label, got, plain(), STOCKHAM_TOL,
                   fast, plain, failed)
        r.update(bound(4 * (x.numel() + got.numel()),
                       fft_flops(x.shape[0] * got.shape[1], nfft),
                       F32_FLOP_PER_S))
        r["library_ms"] = None
        r["spectrum_ms"] = cuda_ms(
            lambda: stk.stft_spectrum_stockham(x, nfft, hop, w, True))
        x_pad = torch.nn.functional.pad(x, (0, hop))
        lib = lambda: torch.stft(x_pad, nfft, hop, window=w, center=False,
                                 return_complex=True).abs().square()
        power_line("stft_power_stockham", label, r, cuda_ms(lib), log,
                   "stockham_power_kernel", nfft, fr_smem(nfft, False))
        return r, got

    out["stft_power_stockham"], _ = power_row(xc, *SMALL, win128, "128/32")
    r, got = power_row(x2, 1024, 8, win1024, "1024/8, 2 ch")
    print(f"  stft_power_stockham [1024/8]: {io(got, x2)}")
    out["stft_power_stockham"].update(
        {f"dense_{k}": v for k, v in r.items()})

    mel_args = (front128.window, front128.mel_fb, front128.mel_bands,
                front128.dct_lift)
    fast = lambda: stk.stft_mel_stockham(xc, *SMALL, *mel_args)
    plain = lambda: stk.stft_mel_stockham_plain(
        xc, *SMALL, front128.window, front128.mel_fb, front128.dct_lift)
    got = fast()
    r = record("stft_mel_stockham", "MFCCFrontend 128/32", got, plain(),
               MFCC_TOL, fast, plain, failed)
    r.update(mel_bound(xc, got, front128))
    r["library_ms"] = None
    print(f"  stft_mel_stockham bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); library call: none (no single PyTorch call "
          f"computes STFT -> mel -> log -> DCT)")
    mma_line("stft_mel_stockham", "MFCCFrontend 128/32", r["ms"],
             r["bound_ms"], r["bound_by"], log,
             *stockham_mel_instance(front128), kind="redesign")
    print("  stockham_mel_kernel instances: " + instance_registers(log, {
        f"<{n}, {fuse}>": f"stockham_mel_kernelILi{n}ELb{int(fuse)}EE"
        for n in (128, 256, 512, 1024, 2048) for fuse in (False, True)}))
    out["stft_mel_stockham"] = r
    w, fb, bands = _mel_constants(1024, 40, 16000.0, 0.0, 8000.0, "htk",
                                  "hann", None, dev)
    fast = lambda: stk.stft_mel_stockham(x2, 1024, 8, w, fb, bands)
    plain = lambda: stk.stft_mel_stockham_plain(x2, 1024, 8, w, fb)
    got = fast()
    record("stft_mel_stockham", f"40 mel energies 1024/8, {io(got, x2)}",
           got, plain(), STOCKHAM_TOL, fast, plain, failed)

    out["stft_gate_stockham"] = gate_phase(xc, x2, failed, log)

    dense_win = STFT(*DENSE).win(dev)
    for onesided in (False, True):
        label = f"512/8 {'one' if onesided else 'two'}-sided"
        fast = lambda: stk.stft_spectrum_stockham(xs, *DENSE, dense_win,
                                                  onesided)
        plain = lambda: stk.stft_spectrum_stockham_plain(xs, *DENSE,
                                                         dense_win, onesided)
        got = fast()
        r = record("stft_spectrum_stockham", label, got, plain(),
                   STOCKHAM_TOL, fast, plain, failed)
        packed = lambda: sk.stft_spectrum(xs, *DENSE, dense_win, onesided)
        r["packed_ms"] = cuda_ms(packed)
        xs_pad = torch.nn.functional.pad(xs, (0, DENSE[1]))
        lib = lambda: torch.stft(xs_pad, *DENSE, window=dense_win,
                                 center=False, onesided=onesided,
                                 return_complex=True)
        assert lib().shape == (c, got.shape[2], got.shape[1])
        r["library_ms"] = cuda_ms(lib)
        r.update(bound(4 * xs.numel() + 8 * got.numel(),
                       fft_flops(c * got.shape[1], DENSE[0]), F32_FLOP_PER_S))
        faster = ("full-nfft" if r["ms"] < r["packed_ms"] else "packed")
        print(f"  [{label}] packed stft_spectrum kernel {r['packed_ms']:.4f} "
              f"ms ({faster} is faster); torch.stft (layout c, bins, frames) "
              f"{r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        redesign_line("stft_spectrum_stockham", label, r, log,
                      "stockham_spectrum_kernel", DENSE[0], onesided,
                      fr_smem(DENSE[0], False))
        if not onesided:
            out["stft_spectrum_stockham"] = r
        else:
            out["stft_spectrum_stockham"].update(
                {f"onesided_{k}": v for k, v in r.items()})
    win2048 = STFT(2048, 16).win(dev)
    for geo, w in ((SMALL, win128), ((2048, 16), win2048)):
        for onesided in (False, True):
            fast = lambda: stk.stft_spectrum_stockham(x2, *geo, w, onesided)
            plain = lambda: stk.stft_spectrum_stockham_plain(x2, *geo, w,
                                                             onesided)
            got = fast()
            record("stft_spectrum_stockham",
                   f"{geo[0]}/{geo[1]} {'one' if onesided else 'two'}-sided, "
                   f"{io(got, x2)}", got, plain(), STOCKHAM_TOL, fast, plain,
                   failed)
    return out


def gate_phase(xc, x2, failed: list, log: list[str]) -> dict:
    """The fused gate kernel on SpectralGate(128, 32)'s padded (16, 479424)
    input: at threshold 0 on the dense input (a pure roundtrip; the run's
    kernel row), at GATE_T on the tone probe, and at GATE_T on the dense
    input, where bins near the threshold may flip between two FFTs (the
    count of samples differing from the plain version run in float64 must
    stay within GATE_FLIPS_FRAMES frames; the count against it in float32
    and the frames where cuFFT's float32 mask differs from float64's are
    printed beside it), each with a redesign line (the <N> instance's ptxas
    figures and the plan's shared memory); then threshold 0 at 1024/8
    (q = 128) on 2 channels."""
    from vv_dsp_tpu_torch.ops import fft_plan
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.ops.framing import stft_num_frames
    from vv_dsp_tpu_torch.ops.stft import STFT
    from vv_dsp_tpu_torch.ops.window import get_window_np

    def padded(x, nfft, hop):
        pad = nfft - hop
        xp = torch.nn.functional.pad(x, (pad, pad))
        n_pad = xp.shape[-1]
        norm = ik.ola_norm(get_window_np("hann", nfft), hop,
                           stft_num_frames(n_pad, nfft, hop), n_pad, x.device)
        return xp, norm, STFT(nfft, hop).win(x.device), pad

    xp, norm, win, pad = padded(xc, *SMALL)
    probe = torch.as_tensor(gate_probe(N_CHAIN, 3, SMALL[0], (10, 25, 45)),
                            device=xc.device)
    pp, _, _, _ = padded(probe, *SMALL)
    r = None
    for label, x, t, edge in (("128/32, threshold 0", xp, 0.0, pad),
                              ("128/32 tone probe, threshold 0.1", pp, GATE_T,
                               2 * pad)):
        fast = lambda: stk.stft_gate_stockham(x, *SMALL, win, norm, t)
        plain = lambda: stk.stft_gate_stockham_plain(x, *SMALL, win, norm, t)
        got, want = fast(), plain()
        if not torch.equal(got, fast()):
            failed.append(f"stft_gate_stockham [{label}] differs between two "
                          f"runs")
        pre_rel = rel_err(got * norm, want * norm)[1]
        print(f"  stft_gate_stockham [{label}] before the norm, full length: "
              f"{pre_rel:.3e} of scale (tol {GATE_TOL:g}) "
              f"{'ok' if pre_rel < GATE_TOL else 'FAIL'}")
        if not pre_rel < GATE_TOL:
            failed.append(f"stft_gate_stockham [{label}] before the norm")
        rr = record("stft_gate_stockham", label, got, want, GATE_TOL, fast,
                    plain, failed, edge=edge)
        if r is None:
            r = rr
    got = stk.stft_gate_stockham(xp, *SMALL, win, norm, GATE_T)
    far = {}
    for dt in (torch.float64, torch.float32):
        want = stk.stft_gate_stockham_plain(xp.to(dt), *SMALL, win.to(dt),
                                            norm.to(dt), GATE_T)
        far[dt] = ((got - want).abs()
                   > GATE_TOL * want.abs().max()).sum().item()
        del want
    masks = []
    for dt in (torch.float32, torch.float64):
        spec = stk.stft_spectrum_stockham_plain(xp.to(dt), *SMALL,
                                                win.to(dt))
        p2 = spec.real * spec.real + spec.imag * spec.imag
        t2 = torch.tensor(GATE_T ** 2, dtype=dt, device=xc.device)
        masks.append(p2 >= t2 * p2.amax(-1, keepdim=True))
        del spec, p2
    cufft_frames = (masks[0] != masks[1]).any(-1).sum().item()
    flips_ok = far[torch.float64] <= GATE_FLIPS_FRAMES * SMALL[0]
    print(f"  stft_gate_stockham dense input at threshold {GATE_T:g}: "
          f"{far[torch.float64]} of {got.numel()} samples differ by more "
          f"than {GATE_TOL:g} of scale from the plain version in float64 "
          f"(bins near the threshold; limit {GATE_FLIPS_FRAMES * SMALL[0]}) "
          f"{'ok' if flips_ok else 'FAIL'}; {far[torch.float32]} from it in "
          f"float32, whose cuFFT spectrum's mask differs from float64's in "
          f"{cufft_frames} frames")
    if not flips_ok:
        failed.append("stft_gate_stockham dense input at threshold "
                      f"{GATE_T:g}: {far[torch.float64]} samples differ")
    r["gated_ms"] = cuda_ms(lambda: stk.stft_gate_stockham(
        xp, *SMALL, win, norm, GATE_T))
    c, n_pad = xp.shape
    nf = stft_num_frames(n_pad, *SMALL)
    r.update(bound(4 * (2 * xp.numel() + n_pad),
                   2 * fft_flops(c * nf, SMALL[0]) + c * nf * 4 * SMALL[0],
                   F32_FLOP_PER_S))
    r["library_ms"] = None
    print(f"  stft_gate_stockham gated {r['gated_ms']:.4f} ms; bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}); library call: none (no "
          f"single PyTorch call computes STFT -> per-frame gate -> ISTFT)")
    for label, ms in (("threshold 0", r["ms"]),
                      (f"threshold {GATE_T:g}", r["gated_ms"])):
        mma_line("stft_gate_stockham", f"128/32 {label}", ms, r["bound_ms"],
                 r["bound_by"], log, f"stockham_gate_kernelILi{SMALL[0]}EE",
                 fft_plan.stockham_gate_smem(*SMALL), kind="redesign")
    print("  stockham_gate_kernel instances: " + instance_registers(log, {
        f"<{n}>": f"stockham_gate_kernelILi{n}EE"
        for n in (128, 256, 512, 1024, 2048)}))
    xq, norm_q, win_q, pad_q = padded(x2, 1024, 8)
    fast = lambda: stk.stft_gate_stockham(xq, 1024, 8, win_q, norm_q, 0.0)
    plain = lambda: stk.stft_gate_stockham_plain(xq, 1024, 8, win_q, norm_q,
                                                 0.0)
    record("stft_gate_stockham", f"1024/8, threshold 0, 2 ch: "
           f"{4 * xq.numel() / 1e6:.2f} MB each way", fast(), plain(),
           GATE_TOL, fast, plain, failed, edge=pad_q)
    return r


def poly_ratio_row(xv, up, down, failed: list) -> dict:
    """poly_kernel at up/down on xv (16 channels): its time, its error
    against the plain version (untimed: about 0.26 s a call) and against
    float64 scipy, the banded upfirdn (f32) and the strided F.conv1d (the
    conv-form upfirdn, cuDNN TF32 off) plus its transpose on the same input,
    and its bound."""
    import torch.nn.functional as F
    from scipy import signal as ss
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops import upfirdn as uf

    c, n = xv.shape
    hr = rs._resample_poly_filter(up, down)
    off, n_out = (len(hr) - 1) // 2, -(-n * up // down)
    table = uf.polyphase_table(hr, up, xv.device)
    got = fk.resample_poly_kernel(xv, up, down)
    if not torch.equal(got, fk.resample_poly_kernel(xv, up, down)):
        failed.append(f"poly_kernel {up}/{down} differs between two runs")
    err, rel = rel_err(got, fk.resample_poly_plain(xv, up, down))
    want = ss.resample_poly(xv.double().cpu().numpy(), up, down, axis=-1)
    rel64 = (np.abs(got.double().cpu().numpy() - want).max()
             / np.abs(want).max())
    ok = rel < POLY_TOL and rel64 < POLY_TOL
    if not ok:
        failed.append(f"poly_kernel [{up}/{down}, {c} x {n}]")
    r = {"max_abs_err": err, "ms": cuda_ms(
        lambda: fk.resample_poly_kernel(xv, up, down))}
    r["banded_ms"] = cuda_ms(lambda: uf.upfirdn_banded(
        xv, table, up, down, off, n_out, "f32"))
    wc, c_lo = rs._upfirdn_conv_plan(tuple(hr), up, down, off)
    frames = -(-n_out // up)
    pad_l = max(0, -c_lo)
    pad_r = max(0, (frames - 1) * down + c_lo + wc.shape[1] - n)
    xb = F.pad(xv[:, None], (pad_l, pad_r))[..., c_lo + pad_l:].contiguous()
    wt = torch.as_tensor(wc, dtype=torch.float32, device=xv.device)[:, None]
    lib = lambda: F.conv1d(xb, wt, stride=down)[..., :frames].transpose(
        1, 2).reshape(c, frames * up)
    lib_err = rel_err(lib()[:, :n_out], got)[1]
    r["library_ms"] = cuda_ms(lib)
    r.update(bound(4 * (xv.numel() + c * n_out + table.numel()),
                   2 * c * n_out * table.shape[1], F32_FLOP_PER_S))
    print(f"kernel poly_kernel [{up}/{down}, {c} x {n} -> {c} x {n_out}]: "
          f"max_abs_err {err:.3e}, {rel:.3e} of scale (tol {POLY_TOL:g}), "
          f"{rel64:.3e} from float64 scipy; kernel {r['ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share of the bound "
          f"{r['bound_ms'] / r['ms']:.3f}; upfirdn_banded (f32) "
          f"{r['banded_ms']:.4f} ms; strided F.conv1d (cuDNN, TF32 off) + "
          f"transpose {r['library_ms']:.4f} ms, {lib_err:.3e} of scale from "
          f"the kernel {'ok' if ok else 'FAIL'}")
    return r


def filter_phase(xc, failed: list, log: list[str]) -> dict:
    """The direct FIR and the per-phase resampler against their plain
    versions at the shapes fir_apply_best and resample_poly_kernel give
    them: fir_direct at 16 taps with F.conv1d (cuDNN's TF32 off), and
    poly_kernel at 4/3 on (16, 479232) timed beside its plain version, then
    at POLY_RATIOS on 16 channels (x cut to a multiple of down), each with
    its error against the plain version and float64 scipy, its bound, the
    strided F.conv1d + transpose and the banded upfirdn on the same input,
    and a redesign line (ptxas's figures of every instance, the plan's
    shared memory); then 2-channel checks at other taps, n < taps and
    other ratios."""
    import torch.nn.functional as F
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    from vv_dsp_tpu_torch.ops import poly_plan as pp
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np

    assert not torch.backends.cudnn.allow_tf32, "cuDNN TF32 must be off"
    c, n = xc.shape
    dev = xc.device
    out = {}
    taps = FIR_TAPS[0]
    h = design_lowpass_np(taps, 0.3)
    fast = lambda: fk.fir_direct(h, xc)
    plain = lambda: fk.fir_direct_plain(h, xc)
    got = fast()
    if not torch.equal(got, fast()):
        failed.append("fir_direct differs between two runs")
    r = record("fir_direct", f"{taps} taps", got, plain(), FIR_TOL, fast,
               plain, failed)
    w = torch.as_tensor(h[::-1].copy(), dtype=torch.float32,
                        device=dev).reshape(1, 1, taps)
    xpad = F.pad(xc[:, None], (taps - 1, 0))
    lib = lambda: F.conv1d(xpad, w)
    lib_err = rel_err(lib()[:, 0], got)[1]
    r["library_ms"] = cuda_ms(lib)
    r.update(bound(4 * (2 * xc.numel() + taps), 2 * xc.numel() * taps,
                   F32_FLOP_PER_S))
    print(f"  F.conv1d (cuDNN, TF32 off) on the left-padded input: "
          f"{r['library_ms']:.4f} ms, {lib_err:.3e} of scale from the "
          f"kernel; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    out["fir_direct"] = r

    up, down = 4, 3
    fast = lambda: fk.resample_poly_kernel(xc, up, down)
    plain = lambda: fk.resample_poly_plain(xc, up, down)
    r = record("poly_kernel", f"{up}/{down}", fast(), plain(), POLY_TOL,
               fast, plain, failed)
    rows = {}
    for u, d in POLY_RATIOS:
        xv = xc[:, :n // d * d].contiguous()
        rows[u, d] = poly_ratio_row(xv, u, d, failed)
    for key in ("banded_ms", "library_ms", "bound_ms", "bound_by"):
        r[key] = rows[up, down][key]
    out["poly_kernel"] = r
    widest = max(pp.kernel_geometries(), key=lambda g: pp.poly_plan(*g).smem)
    smem = ", ".join(f"{u}/{d} {pp.poly_plan(u, d).smem} B "
                     f"({pp.poly_plan(u, d).threads} threads)"
                     for u, d in POLY_RATIOS)
    print(f"  redesign poly_kernel: " + "; ".join(
        f"{u}/{d} {rows[u, d]['ms']:.4f} ms, share of the bound "
        f"{rows[u, d]['bound_ms'] / rows[u, d]['ms']:.3f}"
        for u, d in POLY_RATIOS))
    print(f"  poly_kernel instances: " + instance_registers(
        log, {f"<K={k}>": f"poly_kernelILi{k}EE" for k in pp.K_INSTANCES}))
    print(f"  poly_kernel dynamic shared memory a block (the plan's): "
          f"{smem}; the most of the 377 geometries: {widest[0]}/{widest[1]} "
          f"{pp.poly_plan(*widest).smem} B")

    x2 = xc[:2].contiguous()
    for taps, xv in ((1, x2), (7, x2), (129, x2),
                     (129, x2[:, :100].contiguous())):
        h = design_lowpass_np(taps, 0.3) if taps > 1 else np.array([0.5])
        fast = lambda: fk.fir_direct(h, xv)
        plain = lambda: fk.fir_direct_plain(h, xv)
        record("fir_direct", f"{taps} taps, 2 x {xv.shape[1]}", fast(),
               plain(), FIR_TOL, fast, plain, failed)
    for up, down in ((2, 1), (1, 2), (3, 4), (7, 5), (1, 25), (24, 1),
                     (24, 23)):
        xv = x2[:, :n // down * down].contiguous()
        fast = lambda: fk.resample_poly_kernel(xv, up, down)
        plain = lambda: fk.resample_poly_plain(xv, up, down)
        record("poly_kernel", f"{up}/{down}, 2 x {xv.shape[1]}", fast(),
               plain(), POLY_TOL, fast, plain, failed)
    return out


def fir_os_phase(xc, failed: list, log: list[str]) -> dict:
    """The overlap-save FIR kernel against its plain version at 1,024 taps
    on (16, 479232), beside the banded kernel's f32 tier and
    fir_apply_mxu on the same input, with its bound (the input read and
    the output written once, against os_flops at the float32 peak) and
    ptxas's figures; on 2 channels at 512 and 2,048 taps and at 64 taps on
    100 samples; then the taps sweep at 16 and 64 channels, whose crossover
    sets fir_apply_best's OS_MIN_TAPS."""
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    from vv_dsp_tpu_torch.ops import upfirdn as uf
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np, fir_apply_mxu

    c, n = xc.shape
    taps = FILTER_TIER_TAPS
    h = design_lowpass_np(taps, 0.3)
    table = fk.os_table(h, xc.device)
    fast = lambda: fk.fir_os(xc, table, taps)
    plain = lambda: fk.fir_os_plain(xc, table, taps)
    got = fast()
    if not torch.equal(got, fast()):
        failed.append("fir_os differs between two runs")
    r = record("fir_os", f"{taps} taps, {c} x {n}", got, plain(), OS_TOL,
               fast, plain, failed)
    r.update(bound(4 * 2 * xc.numel(), os_flops(c, n, taps),
                   F32_FLOP_PER_S))
    band = uf.polyphase_table(h, 1, xc.device)
    r["banded_ms"] = cuda_ms(
        lambda: uf.upfirdn_banded(xc, band, 1, 1, 0, n, "f32"))
    r["library_ms"] = None
    mxu_ms = cuda_ms(lambda: fir_apply_mxu(h, xc))
    print(f"  redesign fir_os [{taps} taps, {c} x {n}]: kernel "
          f"{r['ms']:.4f} ms, the banded kernel's f32 tier "
          f"{r['banded_ms']:.4f} ms ({r['banded_ms'] / r['ms']:.2f}x), "
          f"fir_apply_mxu {mxu_ms:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}), share of the bound "
          f"{r['bound_ms'] / r['ms']:.3f}; build.log: "
          f"{usage_text(log, 'fir_os_kernel')}; dynamic shared memory "
          f"{8 * (fk.OS_NFFT + 2 * 2048)} B")
    x2 = xc[:2].contiguous()
    for t, xv in ((512, x2), (2048, x2), (64, x2[:, :100].contiguous())):
        hv = design_lowpass_np(t, 0.3)
        tv = fk.os_table(hv, xc.device)
        fast = lambda: fk.fir_os(xv, tv, t)
        plain = lambda: fk.fir_os_plain(xv, tv, t)
        record("fir_os", f"{t} taps, 2 x {xv.shape[1]}", fast(), plain(),
               OS_TOL, fast, plain, failed)
    for ch in (16, 64):
        xv = torch.randn((ch, n), generator=torch.Generator(
            device=xc.device).manual_seed(ch), device=xc.device)
        for t in OS_SWEEP_TAPS:
            hv = design_lowpass_np(t, 0.3)
            tv = fk.os_table(hv, xc.device)
            bt = uf.polyphase_table(hv, 1, xc.device)
            row = {"os_ms": cuda_ms(lambda: fk.fir_os(xv, tv, t)),
                   "banded_f32_ms": cuda_ms(lambda: uf.upfirdn_banded(
                       xv, bt, 1, 1, 0, n, "f32")),
                   "mxu_ms": cuda_ms(lambda: fir_apply_mxu(hv, xv))}
            print(f"  fir_os sweep [{t} taps, {ch} x {n}]: overlap-save "
                  f"{row['os_ms']:.4f} ms, banded f32 "
                  f"{row['banded_f32_ms']:.4f} ms, fir_apply_mxu "
                  f"{row['mxu_ms']:.4f} ms")
            r[f"sweep_{ch}_{t}"] = row
    return r


def core_phase(xc, failed: list, log: list[str]) -> dict:
    """Savitzky-Golay's kernel path, the banded upfirdn at 1/1 and offset
    wl - 1, against its plain version (the shift-add correlation) at
    savgol_filter's shapes: (31, 3) on (16, 479232), with F.conv1d (cuDNN,
    TF32 off), the bound and ptxas's figures of the instance, and float64
    scipy (mode "mirror") on 2 channels; then wl 5, 101, 257 and deriv 1
    on 2 channels. Then the filter tier at 1,024 taps: fir_apply_os and
    fir_apply_fft timed beside fir_apply_best (the overlap-save kernel) and
    F.conv1d, each held to float64 lfilter, and filtfilt_fir to a float64
    oracle of its own form; then the core API on the card against its CPU
    result. Returns the savgol row's and fir_1024_best's numbers."""
    import torch.nn.functional as F
    from scipy import signal as ss
    from vv_dsp_tpu_torch import config
    from vv_dsp_tpu_torch.ops import dct as dc
    from vv_dsp_tpu_torch.ops import fft as ff
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    from vv_dsp_tpu_torch.ops import fir
    from vv_dsp_tpu_torch.ops import framing as fr
    from vv_dsp_tpu_torch.ops import savgol as sg
    from vv_dsp_tpu_torch.ops import stats
    from vv_dsp_tpu_torch.ops import upfirdn as uf

    assert not torch.backends.cudnn.allow_tf32, "cuDNN TF32 must be off"
    c, n = xc.shape
    x2 = xc[:2].contiguous()
    x64 = x2.double().cpu().numpy()
    tier = config.dot_algorithm(None)
    out = {}
    for wl, order, deriv in (SAVGOL + (0,),) + SAVGOL_OTHERS:
        xv = xc if (wl, order, deriv) == SAVGOL + (0,) else x2
        w_np = sg.savgol_coeffs_np(wl, order, deriv)
        xp = sg._pad(xv, wl // 2, "reflect")
        table = uf.polyphase_table(w_np[::-1], 1, xv.device)
        w = torch.as_tensor(w_np, dtype=torch.float32, device=xv.device)
        fast = lambda: uf.upfirdn_banded(xp, table, 1, 1, wl - 1, n, tier)
        plain = lambda: sg.correlate_plain(xp, w, n)
        got = fast()
        r = record("upfirdn_banded", f"savgol_filter {wl}/{order} deriv "
                   f"{deriv}, {tier}, {xv.shape[0]} x {n}", got, plain(),
                   UPFIRDN_TOL, fast, plain, failed)
        if xv is x2:
            continue
        lib = lambda: F.conv1d(xp[:, None], w.reshape(1, 1, wl))
        lib_err = rel_err(lib()[:, 0], got)[1]
        r["library_ms"] = cuda_ms(lib)
        macs = c * n * wl
        io = 4 * (xp.numel() + c * n + wl)
        r.update(min((bound(io, 2 * macs, F32_FLOP_PER_S),
                      bound(io, 6 * 2 * macs, BF16_FLOP_PER_S)),
                     key=lambda b: b["bound_ms"]))
        entry = lambda: sg.savgol_filter(xc, wl, order)
        r["entry_ms"] = cuda_ms(entry)
        print(f"  savgol_filter({wl}, {order}) on {c} x {n}: entry "
              f"{r['entry_ms']:.4f} ms; F.conv1d (cuDNN, TF32 off) on the "
              f"padded input {r['library_ms']:.4f} ms, {lib_err:.3e} of "
              f"scale from the kernel; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        mma_line("upfirdn_banded", f"savgol {wl}/{order}, {tier}", r["ms"],
                 r["bound_ms"], r["bound_by"], log,
                 *upfirdn_instance(1, 1, wl, wl - 1, tier))
        oracle_check(f"savgol_filter({wl}, {order}) vs float64 scipy "
                     f"(mode mirror, 2 ch)", entry()[:2].cpu().numpy(),
                     ss.savgol_filter(x64, wl, order, mode="mirror",
                                      axis=-1), FIR_TOL)
        out.update({f"savgol_{k}": v for k, v in r.items()})

    taps = FILTER_TIER_TAPS
    h = fir.design_lowpass_np(taps, 0.3)
    want = ss.oaconvolve(x64, h[None], axes=-1)[:, :n]
    wt = torch.as_tensor(h[::-1].copy(), dtype=torch.float32,
                         device=xc.device).reshape(1, 1, taps)
    xpad = F.pad(xc[:, None], (taps - 1, 0))
    lib = lambda: F.conv1d(xpad, wt)
    out["fir_1024_best_library_ms"] = cuda_ms(lib)
    macs, io = c * n * taps, 4 * (2 * xc.numel() + taps)
    b = min((bound(io, 2 * macs, F32_FLOP_PER_S),
             bound(io, 6 * 2 * macs, BF16_FLOP_PER_S)),
            key=lambda v: v["bound_ms"])
    print(f"filter tier bound at {taps} taps, the banded kernel's f32 tier: "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    b = bound(4 * 2 * xc.numel(), os_flops(c, n, taps), F32_FLOP_PER_S)
    out["fir_1024_best_bound_ms"] = b["bound_ms"]
    table = fk.os_table(h, xc.device)
    out["fir_1024_best_os_ms"] = cuda_ms(lambda: fk.fir_os(xc, table, taps))
    before = fk.fir_os.launches
    fk.fir_apply_best(h, xc)
    torch.cuda.synchronize()
    out["fir_1024_best_launches"] = fk.fir_os.launches - before
    print(f"filter tier bound at {taps} taps, the overlap-save kernel: "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); the kernel "
          f"{out['fir_1024_best_os_ms']:.4f} ms, {fk.fir_os.launches - before}"
          f" launch a fir_apply_best call")
    if out["fir_1024_best_launches"] != 1:
        failed.append("fir_apply_best at 1,024 taps: not one fir_os launch")
    forms = (("fir_apply_best (overlap-save kernel)",
              lambda: fk.fir_apply_best(h, xc)),
             ("fir_apply_os", lambda: fir.fir_apply_os(h, xc)),
             ("fir_apply_fft", lambda: fir.fir_apply_fft(h, xc)),
             ("F.conv1d (cuDNN, TF32 off)", lambda: lib()[:, 0]))
    for name, fn in forms:
        ms = cuda_ms(fn)
        if name.startswith("fir_apply_best"):
            out["fir_1024_best_ms"] = ms
        print(f"filter tier {name}, {taps} taps, {c} x {n}: {ms:.4f} ms | "
              f"the conv1d's {out['fir_1024_best_library_ms']:.4f} ms")
        oracle_check(f"filter tier {name} vs float64 lfilter (2 ch)",
                     fn()[:2].cpu().numpy(), want, FIR_TOL)
    pad = taps - 1
    ext = np.pad(x64, ((0, 0), (pad, pad)), mode="symmetric")
    fwd = ss.oaconvolve(ext, h[None], axes=-1)[:, :ext.shape[-1]]
    back = ss.oaconvolve(fwd[:, ::-1], h[None], axes=-1)[:, :ext.shape[-1]]
    want = back[:, ::-1][:, pad:-pad]
    fn = lambda: fir.filtfilt_fir(h, xc)
    print(f"filter tier filtfilt_fir, {taps} taps, {c} x {n}: "
          f"{cuda_ms(fn):.4f} ms")
    oracle_check("filter tier filtfilt_fir vs float64 symmetric pad + "
                 "lfilter forward and back (2 ch)", fn()[:2].cpu().numpy(),
                 want, FIR_TOL)

    frames = xc.reshape(c, -1, 1024)
    rng = np.random.default_rng(5)
    true_phase = np.cumsum(0.3 * rng.standard_normal((c, n)), axis=-1)
    wrapped = ff.phase_wrap(torch.as_tensor(true_phase, dtype=torch.float32))
    win = torch.hann_window(1024, periodic=False, device=xc.device)
    fetched = fr.fetch_frames(xc, 1024, 256, True, win)
    core = [(f"dct type {t}{' inverse' if inv else ''}, 1024 points",
             lambda v, t=t, inv=inv: dc.dct(v, t, inv), frames, CORE_TOL)
            for t in (2, 3, 4) for inv in (False, True)]
    core += [
        ("stats.rms", stats.rms, xc, CORE_TOL),
        ("stats.kurtosis (absolute)", stats.kurtosis, xc, CORE_TOL),
        ("stats.autocorrelation, 1024 lags",
         lambda v: stats.autocorrelation(v, 1024), xc, SPECTRUM_TOL),
        ("framing.fetch_frames, 1024/256 centred",
         lambda v: fr.fetch_frames(v, 1024, 256, True, win.to(v.device)),
         xc, 0.0),
        ("framing.overlap_add, 1024/256",
         lambda v: fr.overlap_add(v, 256, n), fetched, 1e-6),
        ("fft.rfft_power, 1024 points", ff.rfft_power, frames,
         SPECTRUM_TOL),
        ("fft.phase_unwrap", ff.phase_unwrap, wrapped.to(xc.device),
         CORE_TOL)]
    for name, fn, v, tol in core:
        got = fn(v)[:2].cpu()
        want = fn(v[:2].cpu())
        err = (got - want).abs().max().item()
        absolute = "absolute" in name
        if not absolute:
            err /= want.abs().max().item()
        ok = err <= tol
        print(f"core API {name}: {cuda_ms(lambda: fn(v)):.4f} ms on "
              f"{tuple(v.shape)}, {err:.3e}{'' if absolute else ' of scale'} "
              f"from the CPU result (2 ch; limit {tol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"core API {name}")
    return out


def rows_phase(failed: list) -> None:
    """Each kernel wrapper once at ROWS rows of a short signal (two launches:
    65,535 rows, then 1) against its plain version, and its launch count."""
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import mel
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.ops import upfirdn as uf
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np
    from vv_dsp_tpu_torch.ops.framing import stft_num_frames
    from vv_dsp_tpu_torch.ops.stft import STFT
    from vv_dsp_tpu_torch.ops.window import get_window_np

    dev = torch.device("cuda", 0)
    w256, w128 = STFT(256, 64).win(dev), STFT(128, 32).win(dev)
    h256, h128 = get_window_np("hann", 256), get_window_np("hann", 128)
    g = rs._resample_poly_filter(4, 3)
    taps = uf.polyphase_table(g, 4, dev)
    off = (len(g) - 1) // 2
    consts = lambda nfft, n_mels, n_mfcc: mel._mfcc_constants(
        nfft, n_mels, n_mfcc, 8000.0, 0.0, 4000.0, 0.0, "htk", "hann", None,
        dev)
    m256, m128 = consts(256, 24, 12), consts(128, 26, 13)
    n_ola = ik.ola_norm(h256, 64, 2, 320, dev)
    n_gate = ik.periodic_norm(h256, 64, 512, dev)
    n_st = ik.ola_norm(h128, 32, stft_num_frames(256, 128, 32), 256, dev)
    n_ist = ik.ola_norm(h128, 32, 2, 160, dev)
    lp = design_lowpass_np(16, 0.3)
    os_tab = fk.os_table(design_lowpass_np(64, 0.3), dev)
    f32, c64 = torch.float32, torch.complex64
    cases = (   # wrapper, kernel, plain, row shape, dtype, tol, weight
        (uf.upfirdn_banded,
         lambda x: uf.upfirdn_banded(x, taps, 4, 3, off, 128, "f32"),
         lambda x: uf.upfirdn_tall(x, taps, 4, 3, off, 128, "f32"),
         (96,), f32, UPFIRDN_TOL, None),
        (sk.stft_spectrum, lambda x: sk.stft_spectrum(x, 256, 64, w256),
         lambda x: sk.stft_spectrum_plain(x, 256, 64, w256), (320,), f32,
         SPECTRUM_TOL, None),
        (sk.stft_power, lambda x: sk.stft_power(x, 256, 64, w256),
         lambda x: sk.stft_power_plain(x, 256, 64, w256), (320,), f32,
         POWER_TOL, None),
        (sk.stft_mfcc, lambda x: sk.stft_mfcc(
            x, 256, 64, *m256[:3], None, 1e-10, "f32"),
         lambda x: sk.stft_mfcc_plain(x, 256, 64, m256[0], m256[1], None,
                                      1e-10, "f32"), (320,), f32, POWER_TOL,
         None),
        (ik.istft, lambda s: ik.istft(s, 256, 64, 320, w256, n_ola),
         lambda s: ik.istft_plain(s, 256, 64, 320, w256, n_ola), (2, 129),
         c64, ISTFT_TOL, n_ola),
        (ik.stft_gate_packed, lambda x: ik.stft_gate_packed(
            x, 256, 64, 0.0, w256, n_gate),
         lambda x: ik.stft_gate_packed_plain(x, 256, 64, 0.0, w256, n_gate),
         (512,), f32, GATE_TOL, n_gate),
        (stk.stft_spectrum_stockham,
         lambda x: stk.stft_spectrum_stockham(x, 128, 32, w128),
         lambda x: stk.stft_spectrum_stockham_plain(x, 128, 32, w128),
         (160,), f32, STOCKHAM_TOL, None),
        (stk.stft_power_stockham,
         lambda x: stk.stft_power_stockham(x, 128, 32, w128),
         lambda x: stk.stft_power_stockham_plain(x, 128, 32, w128),
         (160,), f32, STOCKHAM_TOL, None),
        (stk.stft_mel_stockham,
         lambda x: stk.stft_mel_stockham(x, 128, 32, *m128[:3]),
         lambda x: stk.stft_mel_stockham_plain(x, 128, 32, m128[0],
                                               m128[1]),
         (160,), f32, STOCKHAM_TOL, None),
        (stk.stft_gate_stockham, lambda x: stk.stft_gate_stockham(
            x, 128, 32, w128, n_st, 0.0),
         lambda x: stk.stft_gate_stockham_plain(x, 128, 32, w128, n_st, 0.0),
         (256,), f32, GATE_TOL, n_st),
        (stk.istft_stockham, lambda s: stk.istft_stockham(
            s, 128, 32, 160, w128, n_ist, rfft=True),
         lambda s: stk.istft_stockham_plain(s, 128, 32, 160, w128, n_ist,
                                            rfft=True),
         (2, 65), c64, ISTFT_TOL, n_ist),
        (sk.stft_power_dft, lambda x: sk.stft_power_dft(x, 256, 128),
         lambda x: sk.stft_power_dft_plain(x, 256, 128), (384,), f32,
         DFT_POWER_TOL, None),
        (fk.fir_direct, lambda x: fk.fir_direct(lp, x),
         lambda x: fk.fir_direct_plain(lp, x), (64,), f32, FIR_TOL, None),
        (fk.resample_poly_kernel, lambda x: fk.resample_poly_kernel(x, 4, 3),
         lambda x: fk.resample_poly_plain(x, 4, 3), (64,), f32, POLY_TOL,
         None),
        (fk.fir_os, lambda x: fk.fir_os(x, os_tab, 64),
         lambda x: fk.fir_os_plain(x, os_tab, 64), (300,), f32, OS_TOL,
         None),
    )
    gen = torch.Generator(device=dev).manual_seed(12)
    for wrapper, fast, plain, shape, dtype, tol, weight in cases:
        x = torch.randn((ROWS,) + shape, dtype=dtype, device=dev,
                        generator=gen)
        if x.is_complex():   # a one-sided spectrum: real DC and Nyquist
            x[..., 0].imag.zero_()
            x[..., -1].imag.zero_()
        before = wrapper.launches
        got = fast(x)
        launches = wrapper.launches - before
        want = plain(x)
        if weight is not None:
            got, want = got * weight, want * weight
        if got.is_complex():
            got, want = torch.view_as_real(got), torch.view_as_real(want)
        err, rel = rel_err(got, want)
        ok = rel < tol and launches == 2 and got.shape == want.shape
        print(f"rows {wrapper.__name__} [{ROWS} x {'x'.join(map(str, shape))}"
              f"]: {launches} launches, max_abs_err {err:.3e}, {rel:.3e} of "
              f"scale (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{wrapper.__name__} at {ROWS} rows")
    torch.cuda.synchronize()


def dft_power_phase(xs, win, failed: list, log: list[str]) -> dict:
    """stft_power_dft at 1024/256 on (16, 480000), with the packed power
    kernel on the same input; then 2 channels at 2048/512, 1024/1024,
    n < nfft, 384/128, 640/128, 1536/512 and 4096/128 (depth 4,096)."""
    from vv_dsp_tpu_torch.ops import mma_plan as mp
    from vv_dsp_tpu_torch.ops import stft_kernels as sk

    fast = lambda: sk.stft_power_dft(xs, NFFT, HOP)
    plain = lambda: sk.stft_power_dft_plain(xs, NFFT, HOP)
    got = fast()
    r = record("stft_power_dft", "1024/256", got, plain(), DFT_POWER_TOL,
               fast, plain, failed)
    r["packed_ms"] = cuda_ms(lambda: sk.stft_power(xs, NFFT, HOP, win))
    c, nf, bins = got.shape
    # the function's bound, as stft_power's (the same function on the same
    # input); the DFT product's 2 * 2 * nfft operations a bin are the
    # kernel's algorithm, read as its achieved rate
    r.update(bound(4 * (xs.numel() + got.numel()),
                   fft_flops(c * nf, NFFT), F32_FLOP_PER_S))
    # the product form's floor: six bf16 products of 2 * 2 * nfft
    # operations a bin at the tensor cores' rate
    gemm_flop = 2 * 2 * c * nf * NFFT * bins
    r["product_floor_ms"] = 6 * gemm_flop / BF16_FLOP_PER_S * 1e3
    r["tensor_tflop_per_s"] = 6 * gemm_flop / r["ms"] / 1e9
    r["library_ms"] = None
    print(f"  stft_power_dft: packed stft_power kernel on the same input "
          f"{r['packed_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); the product form's floor, six products of "
          f"{gemm_flop / 1e9:.2f} GFLOP at 989 TFLOP/s, "
          f"{r['product_floor_ms']:.4f} ms; its bf16 products ran at "
          f"{r['tensor_tflop_per_s']:.1f} TFLOP/s; library call: none "
          f"(torch.stft writes the complex spectrum; the power takes "
          f"another pass)")
    plan = mp.dft_plan(NFFT, HOP)
    mma_line("stft_power_dft", "1024/256", r["ms"], r["bound_ms"],
             r["bound_by"], log,
             f"dft_power_kernelILb{int(plan.tiles > 1)}E", plan.smem)
    x2 = xs[:2]
    for nfft, hop, xv in ((2048, 512, x2), (1024, 1024, x2),
                          (2048, 512, x2[:, :1500].contiguous()),
                          (384, 128, x2), (640, 128, x2), (1536, 512, x2),
                          (4096, 128, x2)):
        fast = lambda: sk.stft_power_dft(xv, nfft, hop)
        plain = lambda: sk.stft_power_dft_plain(xv, nfft, hop)
        record("stft_power_dft", f"{nfft}/{hop}, 2 x {xv.shape[1]}", fast(),
               plain(), DFT_POWER_TOL, fast, plain, failed)
    return r


def istft_stockham_phase(xc, win, failed: list, log: list[str]) -> dict:
    """istft_stockham at 1024/256 on the one-sided spectrum of the
    COLA-padded (16, 479232) input, (16, 1876, 513), with the packed
    inverse kernel on the same spectrum; on a non-Hermitian (16, 1876,
    1024) spectrum with rfft=False (all bins inverted); and at 128/32 on
    the one-sided (16, 14974, 65) spectrum of the input. Each row's
    redesign line gives the <N, RFFT> instance's ptxas figures and the
    plan's shared memory."""
    from vv_dsp_tpu_torch.ops import fft_plan
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.ops.stft import STFT
    from vv_dsp_tpu_torch.ops.window import get_window_np

    xp = torch.nn.functional.pad(xc, (NFFT - HOP, NFFT - HOP))
    half = sk.stft_spectrum(xp, NFFT, HOP, win, True)
    c, nf, _ = half.shape
    gen = torch.Generator(device=xc.device).manual_seed(5)
    full = torch.complex(*(torch.randn((c, nf, NFFT), generator=gen,
                                       device=xc.device) for _ in range(2)))
    win128 = STFT(*SMALL).win(xc.device)
    small = stk.stft_spectrum_stockham(xc, *SMALL, win128, True)
    r = None
    for label, spec, nfft, hop, w, rfft in (
            ("1024/256 rfft=True", half, NFFT, HOP, win, True),
            ("1024/256 rfft=False, non-Hermitian", full, NFFT, HOP, win,
             False),
            ("128/32 rfft=True", small, *SMALL, win128, True)):
        n_out = (spec.shape[1] - 1) * hop + nfft
        norm = ik.ola_norm(get_window_np("hann", nfft), hop, spec.shape[1],
                           n_out, xc.device)
        fast = lambda: stk.istft_stockham(spec, nfft, hop, n_out, w, norm,
                                          rfft)
        plain = lambda: stk.istft_stockham_plain(spec, nfft, hop, n_out, w,
                                                 norm, rfft)
        got, want = fast(), plain()
        if not torch.equal(got, fast()):
            failed.append(f"istft_stockham [{label}] differs between two "
                          f"runs")
        all_rel = rel_err(got, want)[1]
        print(f"  istft_stockham [{label}] all samples: {all_rel:.3e} of "
              f"scale (tol {ISTFT_ALL_TOL:g}) "
              f"{'ok' if all_rel < ISTFT_ALL_TOL else 'FAIL'}")
        if not all_rel < ISTFT_ALL_TOL:
            failed.append(f"istft_stockham [{label}] all samples")
        rr = record("istft_stockham", label, got, want, ISTFT_TOL, fast,
                    plain, failed, edge=nfft)
        rr.update(bound(spec.element_size() * spec.numel()
                        + 4 * (got.numel() + n_out),
                        fft_flops(c * spec.shape[1], nfft)
                        + c * spec.shape[1] * 2 * nfft, F32_FLOP_PER_S))
        mma_line("istft_stockham", label, rr["ms"], rr["bound_ms"],
                 rr["bound_by"], log,
                 f"istft_stockham_kernelILi{nfft}ELb{int(rfft)}E",
                 fft_plan.istft_smem(nfft, hop), kind="redesign")
        if r is None:
            r = rr
            r["packed_ms"] = cuda_ms(lambda: ik.istft(spec, nfft, hop, n_out,
                                                      w, norm))
            print(f"  packed istft kernel on the same spectrum: "
                  f"{r['packed_ms']:.4f} ms")
        elif rfft:
            r.update({f"small_{k}": v for k, v in rr.items()})
        else:
            r.update({f"full_{k}": v for k, v in rr.items()})
    r["library_ms"] = None
    print("  istft_stockham library call: none (torch.istft refuses the Hann "
          "window at center=False: its overlap-add is 0 at sample 0)")
    return r


def gate_packed_phase(xc, win, failed: list, log: list[str]) -> dict:
    """stft_gate_packed at 1024/256 on the COLA-padded (16, 480768) input:
    threshold 0 (a pure roundtrip, the input back on the retained
    samples), GATE_T on the 1024/256 tone probe at the same shape, and
    GATE_T on the dense input (the run's row; bins near the threshold may
    flip between two FFTs, so the count of differing samples must stay
    within GATE_FLIPS_FRAMES frames), with SpectralGate's split pair
    (spectrum kernel, gated inverse kernel) timed on the same input, and a
    redesign line: the <M> instance's ptxas figures and the plan's shared
    memory."""
    from vv_dsp_tpu_torch.ops import fft_plan
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops.framing import stft_num_frames
    from vv_dsp_tpu_torch.ops.window import get_window_np

    pad = NFFT - HOP
    xp = torch.nn.functional.pad(xc, (pad, pad))
    c, n_pad = xp.shape
    norm = ik.periodic_norm(get_window_np("hann", NFFT), HOP, n_pad,
                            xc.device)
    probe = torch.as_tensor(gate_probe(N_CHAIN, 3, channels=c),
                            device=xc.device)
    pp = torch.nn.functional.pad(probe, (pad, pad))
    for label, x, t in (("threshold 0", xp, 0.0),
                        (f"tone probe, {c} ch, threshold {GATE_T:g}", pp,
                         GATE_T)):
        fast = lambda: ik.stft_gate_packed(x, NFFT, HOP, t, win, norm)
        plain = lambda: ik.stft_gate_packed_plain(x, NFFT, HOP, t, win, norm)
        got, want = fast(), plain()
        if not torch.equal(got, fast()):
            failed.append(f"stft_gate_packed [{label}] differs between two "
                          f"runs")
        record("stft_gate_packed", label, got[:, pad:-pad],
               want[:, pad:-pad], GATE_TOL, fast, plain, failed)
        if t == 0.0:
            err = (got[:, pad:-pad] - xc).abs().max().item()
            print(f"  stft_gate_packed [{label}] vs its input, retained "
                  f"samples: {err:.3e} absolute (limit {ROUNDTRIP_TOL:g}) "
                  f"{'ok' if err < ROUNDTRIP_TOL else 'FAIL'}")
            if not err < ROUNDTRIP_TOL:
                failed.append("stft_gate_packed threshold 0 vs its input")
    fast = lambda: ik.stft_gate_packed(xp, NFFT, HOP, GATE_T, win, norm)
    plain = lambda: ik.stft_gate_packed_plain(xp, NFFT, HOP, GATE_T, win,
                                              norm)
    got, want = fast(), plain()
    far = ((got - want)[:, pad:-pad].abs()
           > GATE_TOL * want.abs().max()).sum().item()
    flips_ok = far <= GATE_FLIPS_FRAMES * NFFT
    if not flips_ok:
        failed.append(f"stft_gate_packed dense input at threshold "
                      f"{GATE_T:g}: {far} samples differ")
    r = {"max_abs_err": (got - want)[:, pad:-pad].abs().max().item(),
         "ms": cuda_ms(fast), "plain_ms": cuda_ms(plain)}
    exact = ik.ola_norm(get_window_np("hann", NFFT), HOP,
                        stft_num_frames(n_pad, NFFT, HOP), n_pad, xc.device)

    def split():
        spec = sk.stft_spectrum(xp, NFFT, HOP, win, True)
        return ik.istft(spec, NFFT, HOP, n_pad, win, exact, GATE_T)

    r["split_ms"] = cuda_ms(split)
    nf = stft_num_frames(n_pad, NFFT, HOP)
    r.update(bound(4 * (2 * xp.numel() + n_pad),
                   2 * fft_flops(c * nf, NFFT) + c * nf * 4 * NFFT,
                   F32_FLOP_PER_S))
    r["library_ms"] = None
    print(f"kernel stft_gate_packed [dense, threshold {GATE_T:g}]: {far} of "
          f"{c * (n_pad - 2 * pad)} retained samples differ by more than "
          f"{GATE_TOL:g} of scale (bins near the threshold; limit "
          f"{GATE_FLIPS_FRAMES * NFFT}) {'ok' if flips_ok else 'FAIL'}; "
          f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; "
          f"SpectralGate's split pair {r['split_ms']:.4f} ms; bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}); library call: none (no "
          f"single PyTorch call computes STFT -> per-frame gate -> ISTFT)")
    mma_line("stft_gate_packed", f"{NFFT}/{HOP} threshold {GATE_T:g}",
             r["ms"], r["bound_ms"], r["bound_by"], log,
             f"stft_gate_packed_kernelILi{NFFT // 2}EE",
             fft_plan.gate_packed_smem(NFFT, HOP), kind="redesign")
    return r


def chain_oracle(x64: np.ndarray, chain) -> np.ndarray:
    """The whole chain in float64 numpy/scipy (tests/test_models.py's
    oracle): lfilter -> resample_poly -> framed rfft power -> mel -> log ->
    DCT-II."""
    from scipy import signal as ss
    from vv_dsp_tpu_torch.ops.dct import _dct2_matrix
    from vv_dsp_tpu_torch.ops.mel import mel_filterbank_np
    from vv_dsp_tpu_torch.ops.window import get_window_np

    h = np.asarray(chain.fir_coeffs, np.float64)
    y = ss.lfilter(h, [1.0], x64, axis=-1)
    yr = ss.resample_poly(y, chain.up, chain.down, axis=-1)
    n_out = -(-y.shape[-1] * chain.up // chain.down)
    yr = yr[..., :n_out]
    nfft, hop = chain.nfft, chain.hop
    w = get_window_np(chain.window_name, nfft)
    nf = 1 + (n_out - nfft + hop) // hop
    yp = np.pad(yr, ((0, 0), (0, (nf - 1) * hop + nfft - n_out)))
    frames = np.stack([yp[:, i * hop:i * hop + nfft] for i in range(nf)], 1)
    pw = np.abs(np.fft.rfft(frames * w, axis=-1)) ** 2
    sr = chain.sample_rate * chain.up / chain.down
    fb = mel_filterbank_np(nfft, chain.n_mels, sr, 0.0, sr / 2, "htk")
    lm = np.log(pw @ fb.T + 1e-10)
    return lm @ _dct2_matrix(chain.n_mels)[:chain.n_mfcc].T


def filter_oracles(x64: np.ndarray, outs: dict) -> None:
    """The filter and resample rows' outputs on 2 channels against float64
    scipy: the FIRs as a full convolution cut to n (lfilter's output), the
    resamplers as scipy.signal.resample_poly, the multistage row as the
    same cascade of resample_poly stages."""
    from scipy import signal as ss
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np
    n = x64.shape[-1]
    for taps in FIR_TAPS:
        want = ss.oaconvolve(x64, design_lowpass_np(taps, 0.3)[None],
                             axes=-1)[:, :n]
        oracle_check(f"fir_{taps}_best vs float64 scipy (2 ch)",
                     outs[f"fir_{taps}_best"][:2].cpu().numpy(), want,
                     FIR_TOL)
    for u, d in RATIOS:
        want = ss.resample_poly(x64[:, :n // d * d], u, d, axis=-1)
        oracle_check(f"resample_poly_{u}_{d} vs float64 scipy (2 ch)",
                     outs[f"resample_poly_{u}_{d}"][:2].cpu().numpy(), want,
                     POLY_TOL)
        if (u, d) == (4, 3):
            oracle_check("resample_poly_kernel_4_3 vs float64 scipy (2 ch)",
                         outs["resample_poly_kernel_4_3"][:2].cpu().numpy(),
                         want, POLY_TOL)
    want = x64
    for u, d in rs._factor_stages(160, 147):
        want = ss.resample_poly(want, u, d, axis=-1)
    oracle_check("resample_multistage_160_147 vs float64 scipy stages (2 ch)",
                 outs["resample_multistage_160_147"][:2].cpu().numpy(),
                 want[:, :-(-n * 160 // 147)], POLY_TOL)


def spectrum_oracle(x64: np.ndarray, nfft: int, hop: int) -> np.ndarray:
    from vv_dsp_tpu_torch.ops.window import get_window_np
    n = x64.shape[-1]
    nf = 1 + (n - nfft + hop) // hop
    xp = np.pad(x64, ((0, 0), (0, (nf - 1) * hop + nfft - n)))
    frames = np.stack([xp[:, i * hop:i * hop + nfft] for i in range(nf)], 1)
    return np.fft.fft(frames * get_window_np("hann", nfft), axis=-1)


def frames64(x64: np.ndarray, nfft: int, hop: int) -> np.ndarray:
    """(c, n) -> (c, frames, nfft), zero past the end, in float64."""
    n = x64.shape[-1]
    nf = 1 + (n - nfft + hop) // hop if n >= nfft else 1
    xp = np.pad(x64, ((0, 0), (0, (nf - 1) * hop + nfft - n)))
    idx = np.arange(nf)[:, None] * hop + np.arange(nfft)[None, :]
    return xp[:, idx]


def gate_probe(n: int, seed: int, nfft: int = NFFT,
               bins=(40, 97, 211), channels: int = 2) -> np.ndarray:
    """(channels, n) tones at bin centres of the nfft-point frame (the three bins
    at amplitudes 1, 0.7 and 0.02) over N(0, 1e-4^2) noise. In every frame
    that lies inside the signal, each bin's power is >= 10x above or below
    0.01 of the frame's peak: the main lobes at 1, 0.49 and 4e-4 of the
    peak, their Hann neighbours at 0.25, 0.1225 and 1e-4, the noise far
    below (gate_oracle measures the factor)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = 1e-4 * rng.standard_normal((channels, n))
    for k, a in zip(bins, (1.0, 0.7, 0.02)):
        x += a * np.cos(2 * np.pi * k * t / nfft
                        + rng.uniform(0, 2 * np.pi, (channels, 1)))
    return x.astype(np.float32)


def gate_oracle(x64: np.ndarray, threshold: float, nfft: int = NFFT,
                hop: int = HOP) -> tuple:
    """SpectralGate(nfft, hop) in float64 numpy: (output, the smallest
    factor by which a bin's power clears t^2 times its frame's peak, over
    the frames that lie inside the signal)."""
    from vv_dsp_tpu_torch.ops.window import get_window_np
    n, pad = x64.shape[-1], nfft - hop
    w = get_window_np("hann", nfft)
    fr = frames64(np.pad(x64, ((0, 0), (pad, pad))), nfft, hop)
    spec = np.fft.rfft(fr * w, axis=-1)
    p2 = np.abs(spec) ** 2
    level = threshold ** 2 * p2.max(axis=-1, keepdims=True)
    inside = slice(pad // hop, (pad + n - nfft) // hop + 1)
    factor = 10 ** np.abs(np.log10(p2[:, inside] / level[:, inside])).min()
    y = np.fft.irfft(np.where(p2 >= level, spec, 0), nfft, axis=-1) * w
    nf, total = y.shape[1], n + 2 * pad
    out = np.zeros((2, (nf - 1) * hop + nfft))
    norm = np.zeros(out.shape[1])
    for f in range(nf):
        out[:, f * hop:f * hop + nfft] += y[:, f]
        norm[f * hop:f * hop + nfft] += w * w
    out, norm = out[:, :total], norm[:total]
    out = out / np.where(norm > 1e-12, norm, 1.0)
    return out[:, pad:pad + n], factor


def frontend_oracle(x64: np.ndarray, front) -> np.ndarray:
    """MFCCFrontend in float64 numpy: framed rfft power -> HTK mel -> log
    -> liftered DCT-II."""
    from vv_dsp_tpu_torch.models import frontend_params
    p = frontend_params(front.nfft, front.n_mels, front.n_mfcc,
                        front.sample_rate, front.lifter)
    pw = np.abs(np.fft.rfft(frames64(x64, front.nfft, front.hop)
                            * p["window"], axis=-1)) ** 2
    return np.log(pw @ p["mel_fb"].T + 1e-10) @ p["dct_lift"].T


def oracle_check(name: str, got, want, tol: float, absolute: bool = False):
    got = np.asarray(got, np.complex128 if np.iscomplexobj(got)
                     else np.float64)
    err = np.abs(got - want).max()
    if not absolute:
        err /= np.abs(want).max()
    unit = "absolute" if absolute else "of scale"
    print(f"{name}: {err:.3e} {unit} (limit {tol:g})")
    if not err < tol:
        raise AssertionError(f"{name}: {err:.3e} >= {tol:g}")


def full_nfft_oracles(xc, xs, outs, front128, gate128) -> None:
    """The full-nfft paths' outputs against float64 numpy on 2 channels:
    the 128/32 power and MFCCs on the dense input, SpectralGate(128, 32)
    on its tone probe (the interior, which only frames inside the signal
    reach), and the first 4096 frames of the 512/8 spectra."""
    from vv_dsp_tpu_torch.ops.window import get_window_np
    x2 = xc[:2].double().cpu().numpy()
    w = get_window_np("hann", SMALL[0])
    want = np.abs(np.fft.rfft(frames64(x2, *SMALL) * w, axis=-1)) ** 2
    oracle_check("STFT 128/32 power vs float64 oracle (2 ch)",
                 outs["power 128/32"][:2].cpu().numpy(), want, ORACLE_TOL)
    oracle_check("MFCCFrontend 128/32 vs float64 oracle (2 ch)",
                 outs["MFCCFrontend 128/32"][:2].cpu().numpy(),
                 frontend_oracle(x2, front128), ORACLE_TOL)
    probe = gate_probe(N_CHAIN, 3, SMALL[0], (10, 25, 45))
    want, factor = gate_oracle(probe.astype(np.float64), GATE_T, *SMALL)
    print(f"gate probe 128/32: every bin of the frames inside the signal "
          f"clears the threshold by {factor:.2f}x or more (need 10x)")
    if not factor >= 10:
        raise AssertionError(f"gate probe too close to the threshold: "
                             f"{factor:.2f}x")
    edge = SMALL[0] - SMALL[1]
    got = gate128(torch.as_tensor(probe, device=xc.device)).cpu().numpy()
    oracle_check("SpectralGate 128/32 vs float64 oracle on the probe (2 ch), "
                 "interior", got[:, edge:-edge], want[:, edge:-edge],
                 ORACLE_TOL)
    frames, (nfft, hop) = 4096, DENSE
    head = xs[:2, :(frames - 1) * hop + nfft].double().cpu().numpy()
    idx = np.arange(frames)[:, None] * hop + np.arange(nfft)[None, :]
    want = np.fft.fft(head[:, idx] * get_window_np("hann", nfft), axis=-1)
    for name, bins in (("spectrum 512/8", DENSE[0]),
                       ("spectrum 512/8 one-sided", DENSE[0] // 2 + 1)):
        oracle_check(f"STFT {name} vs float64 oracle (2 ch, {frames} frames)",
                     outs[name][:2, :frames].cpu().numpy(),
                     want[..., :bins], ORACLE_TOL)


def last_slice_oracles(xc, xs, outs, want) -> None:
    """The last slice's rows against float64 numpy on 2 channels: the
    windowed-DFT power and the spectrogram against the 1024/256 FFT oracle
    `want`, the roundtrips and both inverses against their input on the
    COLA-covered interior, and the packed fused gate on the 1024/256 tone
    probe against the float64 gate oracle."""
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops.stft import STFT
    from vv_dsp_tpu_torch.ops.window import get_window_np
    oracle_check("stft_power_pallas 1024/256 vs float64 oracle (2 ch)",
                 outs["stft_power_pallas_1024_256"][:2].cpu().numpy(),
                 np.abs(want[..., :NFFT // 2 + 1]) ** 2, ORACLE_TOL)
    oracle_check("STFT 1024/256 spectrogram vs float64 oracle (2 ch)",
                 outs["stft_1024_256_spectrogram"][:2].cpu().numpy(),
                 np.abs(want), ORACLE_TOL)
    edge = SMALL[0] - SMALL[1]
    oracle_check("STFT 128/32 roundtrip vs its input, interior",
                 outs["stft_128_32_roundtrip"][:, edge:-edge].cpu().numpy(),
                 xc[:, edge:-edge].double().cpu().numpy(), ROUNDTRIP_TOL,
                 absolute=True)
    pad = NFFT - HOP
    for name in ("istft_stockham_1024_256", "istft_stockham_1024_256_full"):
        oracle_check(f"{name} of the padded input's spectrum vs the input",
                     outs[name][:, pad:-pad].cpu().numpy(),
                     xc.double().cpu().numpy(), ROUNDTRIP_TOL, absolute=True)
    probe = gate_probe(N_CHAIN, 3)
    gate_want, _ = gate_oracle(probe.astype(np.float64), GATE_T)
    pp = torch.nn.functional.pad(torch.as_tensor(probe, device=xc.device),
                                 (pad, pad))
    norm = ik.periodic_norm(get_window_np("hann", NFFT), HOP, pp.shape[-1],
                            xc.device)
    got = ik.stft_gate_packed(pp, NFFT, HOP, GATE_T,
                              STFT(NFFT, HOP).win(xc.device),
                              norm)[:, pad:-pad].cpu().numpy()
    oracle_check("stft_gate_packed 1024/256 vs float64 oracle on the probe "
                 "(2 ch), interior", got[:, pad:-pad], gate_want[:, pad:-pad],
                 ORACLE_TOL)


@contextlib.contextmanager
def plan_budget(nbytes: int):
    """Run with the upfirdn plan's shared-memory budget set to nbytes (its
    cached searches dropped before and after)."""
    from vv_dsp_tpu_torch.ops import mma_plan as mp
    old = mp.SMEM_BYTES
    mp._upfirdn_search.cache_clear()
    mp.SMEM_BYTES = nbytes
    try:
        yield
    finally:
        mp.SMEM_BYTES = old
        mp._upfirdn_search.cache_clear()


def route_paths(xc, xs, chain) -> list:
    """The calls the JAX package runs on XLA, which the port runs on the
    card by its "torch" route and which launch no kernel: (name, call on
    the card, the same call on the CPU for 2 channels, input samples a
    channel, tolerance of scale, samples cut at each end before the
    comparison). The gates run on a tone probe whose every bin clears the
    threshold by 10x or more (checked here), so no bin can flip between
    cuFFT and the CPU's FFT; the inverse's spectrum comes from the forward
    kernel, which takes 1024/384, before the counters are zeroed; the
    fused head runs under REFUSING_BUDGET. The gates are compared before
    their norm is divided out."""
    from vv_dsp_tpu_torch.models import MFCCFrontend, SpectralGate
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops.stft import STFT
    from vv_dsp_tpu_torch.ops.window import get_window_np

    probe = gate_probe(N_CHAIN, 4, 128, (10, 25, 45), CHANNELS)
    for hop in (128, 24):
        factor = gate_oracle(probe[:2].astype(np.float64), GATE_T, 128,
                             hop)[1]
        print(f"gate probe 128/{hop}: every bin of the frames inside the "
              f"signal clears the threshold by {factor:.2f}x or more")
        if not factor >= 10:
            raise AssertionError(f"gate probe 128/{hop} too close to the "
                                 f"threshold: {factor:.2f}x")
    probe = torch.as_tensor(probe, device=xc.device)
    z = torch.complex(xs, xs.flip(-1))
    inv = STFT(1024, 384)
    spec = inv.process(xc, rfft=True)
    h = chain.fir_coeffs
    on = {d: (SpectralGate(128, 128, GATE_T, device=d),
              SpectralGate(128, 24, GATE_T, device=d),
              MFCCFrontend(128, 24, device=d)) for d in (xc.device, "cpu")}

    # the gates' outputs times their w^2 norm: compared before the norm is
    # divided out, whose 1/w^2 amplifies float32 rounding without bound
    # where a frame's edge alone covers a sample (at hop == nfft)
    norms = {hop: ik.ola_norm(get_window_np("hann", 128), hop,
                              1 + (N_CHAIN + 2 * (128 - hop) - 128 + hop)
                              // hop, N_CHAIN + 2 * (128 - hop),
                              xc.device)[128 - hop:128 - hop + N_CHAIN]
             for hop in (128, 24)}

    def head(x):
        with plan_budget(REFUSING_BUDGET):
            return rs.fir_resample_fused(h, x, 4, 3)

    return [
        ("route STFT(64, 16).process", lambda: STFT(64, 16).process(xs),
         lambda: STFT(64, 16).process(xs[:2].cpu()), N_STFT, SPECTRUM_TOL,
         0),
        ("route STFT(64, 16).power", lambda: STFT(64, 16).power(xs),
         lambda: STFT(64, 16).power(xs[:2].cpu()), N_STFT, POWER_TOL, 0),
        ("route STFT(1000, 250).spectrogram",
         lambda: STFT(1000, 250).spectrogram(xs),
         lambda: STFT(1000, 250).spectrogram(xs[:2].cpu()), N_STFT,
         SPECTRUM_TOL, 0),
        ("route complex STFT(1024, 256).process",
         lambda: STFT(1024, 256).process(z),
         lambda: STFT(1024, 256).process(z[:2].cpu()), N_STFT,
         SPECTRUM_TOL, 0),
        ("route STFT(1024, 384).reconstruct",
         lambda: inv.reconstruct(spec, N_CHAIN, rfft=True),
         lambda: inv.reconstruct(spec[:2].cpu(), N_CHAIN, rfft=True),
         N_CHAIN, SPECTRUM_TOL, 1024),
        ("route SpectralGate(128, 128)",
         lambda: on[xc.device][0](probe) * norms[128],
         lambda: on["cpu"][0](probe[:2].cpu()) * norms[128].cpu(), N_CHAIN,
         SPECTRUM_TOL, 0),
        ("route SpectralGate(128, 24)",
         lambda: on[xc.device][1](probe) * norms[24],
         lambda: on["cpu"][1](probe[:2].cpu()) * norms[24].cpu(), N_CHAIN,
         SPECTRUM_TOL, 0),
        ("route MFCCFrontend(128, 24)", lambda: on[xc.device][2](xc),
         lambda: on["cpu"][2](xc[:2].cpu()), N_CHAIN, MFCC_TOL, 0),
        ("route fir_resample_fused 4/3, refused head", lambda: head(xc),
         lambda: head(xc[:2].cpu()), N_CHAIN, POLY_TOL, 0)]


def route_checks(routes, outs) -> None:
    """Each routed call's output on the card against its CPU result on 2
    channels (MFCCs against their scale: sum |dct| (|log mel| + 1) bounds
    them, so their max |value| stands in)."""
    for name, _, on_cpu, _, tol, cut in routes:
        got, want = outs[name][:2].cpu(), on_cpu()
        if got.is_complex():
            got, want = torch.view_as_real(got), torch.view_as_real(want)
        if cut:
            got, want = got[..., cut:-cut], want[..., cut:-cut]
        oracle_check(f"{name} on the card vs its CPU result (2 ch)",
                     got.double().numpy(), want.double().numpy(), tol)


def slice_phase(xc, xs, chain, staged, front, front128, card: str) -> dict:
    """Drive every entry point of the slice once, each with the launch
    counters, the fused head's ``tails_in_place`` and the spectrum's
    ``edge_pads`` zeroed just before it and read just after (one edge pad
    for SpectralGate, none elsewhere), then check and time them. Returns each kernel's
    launches summed over the paths."""
    from vv_dsp_tpu_torch.models import SpectralGate
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops import savgol as sg
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np
    from vv_dsp_tpu_torch.ops.stft import STFT
    from vv_dsp_tpu_torch.ops.window import get_window_np

    counters = kernel_counters()
    plan = STFT(NFFT, HOP)
    gate = SpectralGate()
    firs = {taps: design_lowpass_np(taps, 0.3) for taps in FIR_TAPS}
    cut = {d: xc[:, :N_CHAIN // d * d] for _, d in RATIOS}
    small, dense = STFT(*SMALL), STFT(*DENSE)
    gate128 = SpectralGate(*SMALL, GATE_T)
    ones = torch.ones(NFFT // 2 + 1, device=xc.device)
    roundtrip = lambda: plan.reconstruct(plan.process(xc, rfft=True),
                                         N_CHAIN, rfft=True)
    packed = lambda: plan.reconstruct_packed(
        plan.process_packed(xc).apply_mask(ones), N_CHAIN)
    # each path with the exact launches it must make
    synthesis = {"stft_spectrum": 1, "istft": 1}
    paths = (
        ("chain", lambda: chain(xc), {"upfirdn_banded": 1, "stft_mfcc": 1}),
        ("spectrum", lambda: plan.process(xs, rfft=False),
         {"stft_spectrum": 1}),
        ("SpectralGate", lambda: gate(xc), synthesis),
        ("roundtrip", roundtrip, synthesis),
        ("packed roundtrip", packed, synthesis),
        ("power", lambda: plan.power(xs), {"stft_power": 1}),
        ("MFCCFrontend", lambda: front(xc), {"stft_mfcc": 1}),
        ("power 128/32", lambda: small.power(xc), {"stft_power_stockham": 1}),
        ("MFCCFrontend 128/32", lambda: front128(xc),
         {"stft_mel_stockham": 1}),
        ("SpectralGate 128/32", lambda: gate128(xc),
         {"stft_gate_stockham": 1}),
        ("spectrum 512/8", lambda: dense.process(xs, rfft=False),
         {"stft_spectrum_stockham": 1}),
        ("spectrum 512/8 one-sided", lambda: dense.process(xs, rfft=True),
         {"stft_spectrum_stockham": 1}),
        ("staged chain", lambda: staged(xc),
         {"fir_os": 1, "upfirdn_banded": 1, "stft_mfcc": 1}))
    # the filter and resample entry points on the TPU's routes, with the
    # input samples a channel each row counts
    filter_paths = [
        (f"fir_{taps}_best", lambda h=h: fk.fir_apply_best(h, xc), want,
         N_CHAIN)
        for (taps, h), want in zip(firs.items(), (
            {"fir_direct": 1}, {}, {}, {"fir_os": 1}))]
    filter_paths += [
        (f"resample_poly_{u}_{d}",
         lambda u=u, d=d: fk.resample_poly_best(cut[d], u, d), want,
         cut[d].shape[1])
        for (u, d), want in zip(RATIOS, (
            {"upfirdn_banded": 1}, {"upfirdn_banded": 1},
            {"upfirdn_banded": 1}, {}))]
    filter_paths += [
        ("resample_multistage_160_147",
         lambda: rs.resample_multistage(xc, 160, 147), {"upfirdn_banded": 3},
         N_CHAIN),
        ("resample_poly_kernel_4_3",
         lambda: fk.resample_poly_kernel(xc, 4, 3), {"poly_kernel": 1},
         N_CHAIN),
        (f"savgol_{SAVGOL[0]}_{SAVGOL[1]}",
         lambda: sg.savgol_filter(xc, *SAVGOL), {"upfirdn_banded": 1},
         N_CHAIN)]
    paths += tuple(p[:3] for p in filter_paths)
    routes = route_paths(xc, xs, chain)
    paths += tuple((name, fn, {}) for name, fn, *_ in routes)
    # the last slice: the windowed-DFT power, the 128-point roundtrip, the
    # full-nfft inverse (both forms) of the COLA-padded input's spectra, the
    # packed fused gate on that input and the magnitude spectrogram
    pad = NFFT - HOP
    xp = torch.nn.functional.pad(xc, (pad, pad))
    n_pad = xp.shape[-1]
    half, full = plan.process(xp, rfft=True), plan.process(xp, rfft=False)
    win = plan.win(xc.device)
    inv_norm = ik.ola_norm(get_window_np("hann", NFFT), HOP, half.shape[1],
                           n_pad, xc.device)
    gate_norm = ik.periodic_norm(get_window_np("hann", NFFT), HOP, n_pad,
                                 xc.device)
    small_rt = lambda: small.reconstruct(small.process(xc, rfft=True),
                                         N_CHAIN, rfft=True)
    last_paths = (
        ("stft_power_pallas_1024_256",
         lambda: sk.stft_power_dft(xs, NFFT, HOP), {"stft_power_dft": 1},
         N_STFT),
        ("stft_128_32_roundtrip", small_rt,
         {"stft_spectrum_stockham": 1, "istft_stockham": 1}, N_CHAIN),
        ("istft_stockham_1024_256", lambda: stk.istft_stockham(
            half, NFFT, HOP, n_pad, win, inv_norm, rfft=True),
         {"istft_stockham": 1}, n_pad),
        ("istft_stockham_1024_256_full", lambda: stk.istft_stockham(
            full, NFFT, HOP, n_pad, win, inv_norm, rfft=False),
         {"istft_stockham": 1}, n_pad),
        ("stft_gate_packed_1024_256", lambda: ik.stft_gate_packed(
            xp, NFFT, HOP, GATE_T, win, gate_norm),
         {"stft_gate_packed": 1}, n_pad),
        ("stft_1024_256_spectrogram", lambda: plan.spectrogram(xs),
         {"stft_spectrum": 1}, N_STFT))
    paths += tuple(p[:3] for p in last_paths)
    # the fused head's staged tails, each written into the head's buffer,
    # and the spectrum launches that read an edge pad in place
    tails = {"chain": 1, "route fir_resample_fused 4/3, refused head": 1}
    edge_pads = {"SpectralGate": 1}
    outs, launches = {}, dict.fromkeys(counters, 0)
    for name, fn, want in paths:
        for counted in counters.values():
            counted.launches = 0
        rs.fir_resample_fused.tails_in_place = 0
        sk.stft_spectrum.edge_pads = 0
        outs[name] = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in counters.items() if f.launches}
        in_place = rs.fir_resample_fused.tails_in_place
        pads = sk.stft_spectrum.edge_pads
        print(f"launches [{name}]: {got}, tails in place {in_place}, "
              f"stft_spectrum.edge_pads {pads}")
        if got != want:
            raise AssertionError(f"{name} launched {got}, expected {want}")
        if in_place != tails.get(name, 0):
            raise AssertionError(f"{name} wrote {in_place} tails in place, "
                                 f"expected {tails.get(name, 0)}")
        if pads != edge_pads.get(name, 0):
            raise AssertionError(f"{name} read {pads} edge pads in place, "
                                 f"expected {edge_pads.get(name, 0)}")
        for k, count in got.items():
            launches[k] += count
    print(f"slice launches, summed over the paths: {launches}")
    feats, spec, gated = outs["chain"], outs["spectrum"], outs["SpectralGate"]
    rt, rtp = outs["roundtrip"], outs["packed roundtrip"]
    power, mfcc = outs["power"], outs["MFCCFrontend"]

    nf_chain = 1 + (-(-N_CHAIN * 4 // 3) - 2048 + 512) // 512
    nf_front = 1 + (N_CHAIN - NFFT + HOP) // HOP
    nf_small = 1 + (N_CHAIN - SMALL[0] + SMALL[1]) // SMALL[1]
    nf_dense = 1 + (N_STFT - DENSE[0] + DENSE[1]) // DENSE[1]
    for name, t, shape, dtype in (
            ("chain", feats, (CHANNELS, nf_chain, 20), torch.float32),
            ("spectrum", spec, (CHANNELS, 1873, NFFT), torch.complex64),
            ("SpectralGate", gated, (CHANNELS, N_CHAIN), torch.float32),
            ("roundtrip", rt, (CHANNELS, N_CHAIN), torch.float32),
            ("packed roundtrip", rtp, (CHANNELS, N_CHAIN), torch.float32),
            ("power", power, (CHANNELS, 1873, NFFT // 2 + 1), torch.float32),
            ("MFCCFrontend", mfcc, (CHANNELS, nf_front, 13), torch.float32),
            ("power 128/32", outs["power 128/32"],
             (CHANNELS, nf_small, SMALL[0] // 2 + 1), torch.float32),
            ("MFCCFrontend 128/32", outs["MFCCFrontend 128/32"],
             (CHANNELS, nf_small, 13), torch.float32),
            ("SpectralGate 128/32", outs["SpectralGate 128/32"],
             (CHANNELS, N_CHAIN), torch.float32),
            ("spectrum 512/8", outs["spectrum 512/8"],
             (CHANNELS, nf_dense, DENSE[0]), torch.complex64),
            ("spectrum 512/8 one-sided", outs["spectrum 512/8 one-sided"],
             (CHANNELS, nf_dense, DENSE[0] // 2 + 1), torch.complex64),
            ("staged chain", outs["staged chain"], (CHANNELS, nf_chain, 20),
             torch.float32),
            *((f"fir_{taps}_best", outs[f"fir_{taps}_best"],
               (CHANNELS, N_CHAIN), torch.float32) for taps in FIR_TAPS),
            *((f"resample_poly_{u}_{d}", outs[f"resample_poly_{u}_{d}"],
               (CHANNELS, -(-(N_CHAIN // d * d) * u // d)), torch.float32)
              for u, d in RATIOS),
            ("resample_multistage_160_147",
             outs["resample_multistage_160_147"],
             (CHANNELS, -(-N_CHAIN * 160 // 147)), torch.float32),
            ("resample_poly_kernel_4_3", outs["resample_poly_kernel_4_3"],
             (CHANNELS, N_CHAIN * 4 // 3), torch.float32),
            (f"savgol_{SAVGOL[0]}_{SAVGOL[1]}",
             outs[f"savgol_{SAVGOL[0]}_{SAVGOL[1]}"], (CHANNELS, N_CHAIN),
             torch.float32),
            ("stft_power_pallas_1024_256", outs["stft_power_pallas_1024_256"],
             (CHANNELS, 1873, NFFT // 2 + 1), torch.float32),
            *((name, outs[name], (CHANNELS, n_pad), torch.float32)
              for name in ("istft_stockham_1024_256",
                           "istft_stockham_1024_256_full",
                           "stft_gate_packed_1024_256")),
            ("stft_128_32_roundtrip", outs["stft_128_32_roundtrip"],
             (CHANNELS, N_CHAIN), torch.float32),
            ("stft_1024_256_spectrogram", outs["stft_1024_256_spectrogram"],
             (CHANNELS, 1873, NFFT), torch.float32)):
        assert tuple(t.shape) == shape, (name, tuple(t.shape))
        assert t.dtype == dtype, (name, t.dtype)
        vals = torch.view_as_real(t) if t.is_complex() else t
        assert torch.isfinite(vals).all().item(), f"non-finite {name}"

    x2 = xc[:2].double().cpu().numpy()
    chain_want = chain_oracle(x2, chain)
    oracle_check("chain vs float64 oracle (2 ch)",
                 feats[:2].cpu().numpy(), chain_want, 5e-5)
    oracle_check("staged chain vs float64 oracle (2 ch)",
                 outs["staged chain"][:2].cpu().numpy(), chain_want, 5e-5)
    oracle_check("staged chain vs the fused chain (16 ch)",
                 outs["staged chain"].cpu().numpy(),
                 feats.double().cpu().numpy(), STAGED_TOL)
    filter_oracles(x2, outs)
    route_checks(routes, outs)
    want = spectrum_oracle(xs[:2].double().cpu().numpy(), NFFT, HOP)
    oracle_check("STFT 1024/256 vs float64 oracle (2 ch)",
                 spec[:2].cpu().numpy(), want, 5e-5)
    oracle_check("STFT 1024/256 power vs float64 oracle (2 ch)",
                 power[:2].cpu().numpy(),
                 np.abs(want[..., :NFFT // 2 + 1]) ** 2, ORACLE_TOL)
    edge = NFFT - HOP  # the COLA-covered interior
    for name, y in (("roundtrip", rt), ("packed roundtrip", rtp)):
        oracle_check(f"STFT 1024/256 {name} vs its input, interior",
                     y[:, edge:-edge].cpu().numpy(),
                     xc[:, edge:-edge].double().cpu().numpy(),
                     ROUNDTRIP_TOL, absolute=True)
    probe = gate_probe(N_CHAIN, 3)
    want, factor = gate_oracle(probe.astype(np.float64), GATE_T)
    print(f"gate probe: every bin of the frames inside the signal clears "
          f"the threshold by {factor:.2f}x or more (need 10x)")
    if not factor >= 10:
        raise AssertionError(f"gate probe too close to the threshold: "
                             f"{factor:.2f}x")
    got = gate(torch.as_tensor(probe, device=xc.device)).cpu().numpy()
    oracle_check("SpectralGate vs float64 oracle on the probe (2 ch), "
                 "interior", got[:, edge:-edge], want[:, edge:-edge],
                 ORACLE_TOL)
    oracle_check("MFCCFrontend vs float64 oracle (2 ch)",
                 mfcc[:2].cpu().numpy(), frontend_oracle(x2, front),
                 ORACLE_TOL)
    full_nfft_oracles(xc, xs, outs, front128, gate128)
    last_slice_oracles(xc, xs, outs, want=spectrum_oracle(
        xs[:2].double().cpu().numpy(), NFFT, HOP))

    rows = (("northstar_chain_throughput", lambda: chain(xc), N_CHAIN),
            ("stft_1024_256_throughput",
             lambda: plan.process(xs, rfft=False), N_STFT),
            ("pipeline_spectral_gate", lambda: gate(xc), N_CHAIN),
            ("stft_1024_roundtrip", roundtrip, N_CHAIN),
            ("stft_1024_roundtrip_packed", packed, N_CHAIN),
            ("stft_128_32_power_throughput", lambda: small.power(xc),
             N_CHAIN),
            ("mfcc_frontend_128_32_throughput", lambda: front128(xc),
             N_CHAIN),
            ("pipeline_spectral_gate_128_32", lambda: gate128(xc), N_CHAIN),
            ("stft_512_8_throughput", lambda: dense.process(xs, rfft=False),
             N_STFT),
            ("stft_512_8_rfft_throughput",
             lambda: dense.process(xs, rfft=True), N_STFT),
            ("northstar_chain_staged_throughput", lambda: staged(xc),
             N_CHAIN),
            *((name, fn, n) for name, fn, _, n in filter_paths),
            *((name, fn, n) for name, fn, _, n in last_paths),
            *((name, fn, n) for name, fn, _, n, *_ in routes))
    for name, fn, n in rows:
        ms = cuda_ms(fn)
        print(f"{name} {CHANNELS * n / ms / 1e3:.2f} Msamples/s "
              f"({ms:.4f} ms, {CHANNELS} x {n}) | {card}")
    return launches


def kernel_counters() -> dict:
    """The 15 kernel wrappers by name, each counting its launches."""
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    from vv_dsp_tpu_torch.ops import istft_kernels as ik
    from vv_dsp_tpu_torch.ops import stft_kernels as sk
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.ops import upfirdn as uf
    return {"upfirdn_banded": uf.upfirdn_banded,
            "stft_mfcc": sk.stft_mfcc, "stft_spectrum": sk.stft_spectrum,
            "stft_power": sk.stft_power, "istft": ik.istft,
            "stft_power_stockham": stk.stft_power_stockham,
            "stft_mel_stockham": stk.stft_mel_stockham,
            "stft_gate_stockham": stk.stft_gate_stockham,
            "stft_spectrum_stockham": stk.stft_spectrum_stockham,
            "fir_direct": fk.fir_direct,
            "poly_kernel": fk.resample_poly_kernel,
            "stft_power_dft": sk.stft_power_dft,
            "istft_stockham": stk.istft_stockham,
            "stft_gate_packed": ik.stft_gate_packed,
            "fir_os": fk.fir_os}


def stream_oracle(x64: np.ndarray, chain) -> np.ndarray:
    """StreamingNorthStar's frames after its warm-up, flush included, in
    float64 numpy/scipy: the FIR, the resampler's delay_in zeros before the
    signal (its fixed lead-in), resample_poly, the framed rfft power, the
    mel filterbank at the output rate, log, DCT-II."""
    from scipy import signal as ss
    from vv_dsp_tpu_torch.ops.mel import mel_filterbank_np, mfcc_dct_np
    from vv_dsp_tpu_torch.ops.window import get_window_np

    h = np.asarray(chain.fir_coeffs, np.float64)
    y = ss.oaconvolve(x64, h[None], axes=-1)[:, :x64.shape[-1]]
    y = np.pad(y, ((0, 0), (chain._resampler._geometry[3], 0)))
    yr = ss.resample_poly(y, chain.up, chain.down, axis=-1)
    yr = yr[:, :-(-y.shape[-1] * chain.up // chain.down)]
    nfft, hop = chain.nfft, chain.hop
    pw = np.abs(np.fft.rfft(frames64(yr, nfft, hop)
                            * get_window_np(chain.window, nfft),
                            axis=-1)) ** 2
    sr = chain.sample_rate * chain.up / chain.down
    fb = mel_filterbank_np(nfft, chain.n_mels, sr, 0.0, sr / 2, "htk")
    return (np.log(pw @ fb.T + 1e-10)
            @ mfcc_dct_np(chain.n_mels, chain.n_mfcc).T)


def lpc64(x64: np.ndarray, order: int) -> np.ndarray:
    """The reference's LPC (lpc.c:7-41) in float64: the autocorrelation
    sum_i x[i] x[i+k], then the Levinson-Durbin recursion."""
    n = x64.shape[-1]
    spec = np.fft.rfft(x64, 2 * n)
    r = np.fft.irfft(spec * np.conj(spec), 2 * n)[:, :order + 1]
    out = np.zeros((len(x64), order + 1))
    for c in range(len(x64)):
        a, e = np.zeros(order + 1), r[c, 0]
        a[0] = 1.0
        for m in range(1, order + 1):
            k = -(r[c, m] + a[1:m] @ r[c, m - 1:0:-1]) / e
            a[1:m] = a[1:m] + k * a[m - 1:0:-1]
            a[m] = k
            e *= 1.0 - k * k
        out[c] = a
    return out


def analysis_paths(xc, xst, tone, chain) -> list:
    """The analysis, IIR and streaming tier's paths: (name, call, the
    launches it must make). Each runs plain PyTorch on the card and
    launches no kernel of the port, as the JAX package runs no Pallas
    kernel there, except the streamed chain's offline composition, whose
    STFT(2048, 512).power takes the packed power kernel."""
    from scipy import signal as ss
    from vv_dsp_tpu_torch import streaming as st
    from vv_dsp_tpu_torch.ops import czt, envelope, fir, hilbert, iir, mel
    from vv_dsp_tpu_torch.ops import resample as rs
    from vv_dsp_tpu_torch.ops.stft import STFT

    sos4, sos18 = iir.butter_sos(4, 0.2), iir.butter_sos(18, 0.2)
    b6, a6 = ss.butter(6, 0.25)
    w = np.exp(-2j * np.pi / CZT_M)
    zoom = czt.czt_params_for_freq_range(800.0, 1200.0, 512, 48000.0)
    segs = xc.reshape(-1, CZT_M)

    def iir_stream():
        state = st.iir_stream_init(sos4, (CHANNELS,), device=xc.device)
        return st.scan_stream(lambda s, b: st.iir_stream_process(sos4, s, b),
                              state, xc, STREAM_BLOCKS[0])[0]

    def streamed(block):
        def run():
            feats, state = chain.process_blocks(
                chain.init((CHANNELS,), device=xst.device), xst, block)
            return torch.cat([feats, chain.flush(state)], dim=-2)
        return run

    def offline():
        y = fir.fir_apply(chain.fir_coeffs, xst)
        y = rs.resample_poly(torch.nn.functional.pad(
            y, (chain._resampler._geometry[3], 0)), chain.up, chain.down)
        return mel.mfcc(STFT(chain.nfft, chain.hop).power(y), chain.nfft,
                        chain.n_mels, chain.n_mfcc,
                        chain.sample_rate * chain.up / chain.down)

    def phase_and_frequency():
        phase = hilbert.instantaneous_phase(hilbert.hilbert_analytic(tone))
        return torch.stack([phase,
                            hilbert.instantaneous_frequency(phase, 48000.0)])

    return [
        ("iir_butter4", lambda: iir.iir_apply(sos4, xc), {}),
        ("iir_butter18_scan", lambda: iir.iir_apply(sos18, xc), {}),
        ("filtfilt_sos_butter4", lambda: iir.filtfilt_sos(sos4, xc), {}),
        ("lfilter_order2", lambda: iir.lfilter(
            [0.2, 0.3, 0.1], [1.0, -0.5, 0.2], xc), {}),
        ("lfilter_order6", lambda: iir.lfilter(b6, a6, xc), {}),
        (f"iir_stream_block{STREAM_BLOCKS[0]}", iir_stream, {}),
        ("hilbert_analytic", lambda: hilbert.hilbert_analytic(xc), {}),
        ("hilbert_envelope", lambda: hilbert.envelope(xc), {}),
        ("instantaneous_frequency_tone", phase_and_frequency, {}),
        ("czt_4096_dft_equiv", lambda: czt.czt(xc[:, :CZT_M], CZT_M, w), {}),
        ("czt_4096_batched", lambda: czt.czt(segs, CZT_M, w), {}),
        ("czt_zoom_512", lambda: czt.czt(xc[:, :CZT_M], 512, *zoom), {}),
        ("cepstrum_4096", lambda: envelope.cepstrum_real(xc[:, :CZT_M]), {}),
        ("lpc_16", lambda: envelope.lpc(xc, 16)[0], {}),
        *((f"streaming_north_star_block{b}", streamed(b), {})
          for b in STREAM_BLOCKS),
        ("streaming_offline_composition", offline, {"stft_power": 1}),
    ]


def allclose_check(name: str, got, want, rtol: float, atol: float) -> None:
    """numpy's assert_allclose(got, want, rtol, atol), as the JAX tests
    hold these functions: |got - want| <= atol + rtol |want| everywhere."""
    diff = np.abs(got - want)
    err = (diff - rtol * np.abs(want)).max()
    print(f"{name}: max(|err| - {rtol:g} |want|) {err:.3e} (limit atol "
          f"{atol:.3e}); max |err| {diff.max():.3e}, "
          f"{diff.max() / np.abs(want).max():.3e} of scale")
    if not err <= atol:
        raise AssertionError(f"{name}: {err:.3e} > {atol:.3e}")


def czt_check(name: str, got, want, tol) -> None:
    """tests/test_czt.py's contract: rtol tol[0], atol tol[1] of max."""
    allclose_check(name, got, want, tol[0], tol[1] * np.abs(want).max())


def analysis_checks(outs, xc, xst, tone, chain) -> None:
    """Every output of analysis_paths against float64 scipy/numpy on 2
    channels; the IIR stream and the streamed chain also against their
    offline forms on the card, on all 16."""
    from scipy import signal as ss
    from vv_dsp_tpu_torch.ops import iir
    from vv_dsp_tpu_torch.ops.czt import czt_params_for_freq_range

    x2 = xc[:2].double().cpu().numpy()
    sos4, sos18 = iir.butter_sos(4, 0.2), iir.butter_sos(18, 0.2)
    b6, a6 = ss.butter(6, 0.25)
    assert iir._block_path_ok(iir.normalize_sos(sos4), N_CHAIN)
    assert iir._block_path_ok(iir.normalize_sos(iir.tf2sos(b6, a6)), N_CHAIN)
    assert not iir._block_path_ok(iir.normalize_sos(sos18), N_CHAIN)
    for name, want in (
            ("iir_butter4", ss.sosfilt(sos4, x2)),
            ("iir_butter18_scan", ss.sosfilt(sos18, x2)),
            ("filtfilt_sos_butter4", ss.sosfiltfilt(sos4, x2)),
            ("lfilter_order2", ss.lfilter([0.2, 0.3, 0.1], [1.0, -0.5, 0.2],
                                          x2)),
            ("lfilter_order6", ss.lfilter(b6, a6, x2))):
        oracle_check(f"{name} vs float64 scipy (2 ch)",
                     outs[name][:2].cpu().numpy(), want, IIR_TOL)
    name = f"iir_stream_block{STREAM_BLOCKS[0]}"
    oracle_check(f"{name} vs iir_apply offline (16 ch, on the card)",
                 outs[name].cpu().numpy(),
                 outs["iir_butter4"].double().cpu().numpy(), IIR_STREAM_TOL)

    z64 = ss.hilbert(x2)
    oracle_check("hilbert_analytic vs float64 scipy (2 ch)",
                 outs["hilbert_analytic"][:2].cpu().numpy(), z64,
                 HILBERT_TOL, absolute=True)
    oracle_check("hilbert_envelope vs float64 scipy (2 ch)",
                 outs["hilbert_envelope"][:2].cpu().numpy(), np.abs(z64),
                 HILBERT_TOL, absolute=True)
    # a 1 kHz tone at 48 kHz: the float32 phase reaches ~6e4 rad, so its
    # difference is quantized to the phase's spacing; the mean frequency
    # within 0.5 Hz (tests/test_hilbert.py), each sample within two
    # spacings of float64's
    fs = 48000.0
    phase, freq = outs["instantaneous_frequency_tone"][:, :2].cpu().numpy()
    phase64 = np.unwrap(np.angle(ss.hilbert(
        tone[:2].double().cpu().numpy())), axis=-1)
    oracle_check("instantaneous_phase of a tone vs float64 (2 ch)", phase,
                 phase64, ORACLE_TOL)
    inner = slice(1000, -1000)
    spacing = float(np.spacing(np.abs(phase).max())) * fs / (2 * np.pi)
    err = np.abs(freq[:, 1:][:, inner]
                 - (np.diff(phase64, axis=-1) * fs / (2 * np.pi))[:, inner])
    mean = freq[:, inner].mean(axis=-1)
    print(f"instantaneous_frequency of a 1 kHz tone (2 ch): mean "
          f"{mean.tolist()} Hz (limit 0.5 Hz off), {err.max():.3f} Hz from "
          f"float64 (limit two phase spacings, {2 * spacing:.3f} Hz)")
    if not (np.abs(mean - 1000.0).max() < 0.5 and err.max() < 2 * spacing):
        raise AssertionError("instantaneous_frequency of the tone")

    xs2 = xc[:2, :CZT_M].double().cpu().numpy()
    czt_check("czt_4096_dft_equiv vs float64 scipy (2 ch)",
              outs["czt_4096_dft_equiv"][:2].cpu().numpy(),
              ss.czt(xs2, CZT_M, np.exp(-2j * np.pi / CZT_M)), CZT_DFT_TOL)
    czt_check("czt_4096_batched vs float64 FFT (2 segments)",
              outs["czt_4096_batched"][:2].cpu().numpy(),
              np.fft.fft(xc.reshape(-1, CZT_M)[:2].double().cpu().numpy()),
              CZT_DFT_TOL)
    czt_check("czt_zoom_512 (800-1200 Hz at 48 kHz) vs float64 scipy (2 ch)",
              outs["czt_zoom_512"][:2].cpu().numpy(),
              ss.czt(xs2, 512, *czt_params_for_freq_range(
                  800.0, 1200.0, 512, 48000.0)), CZT_ZOOM_TOL)
    oracle_check("cepstrum_4096 vs float64 numpy (2 ch)",
                 outs["cepstrum_4096"][:2].cpu().numpy(),
                 np.fft.ifft(np.log(np.abs(np.fft.fft(xs2)) + 1e-12)).real,
                 ORACLE_TOL)
    oracle_check("lpc_16 vs float64 numpy (2 ch)",
                 outs["lpc_16"][:2].cpu().numpy(), lpc64(x2, 16), LPC_TOL)

    offline = outs["streaming_offline_composition"].double().cpu().numpy()
    want = stream_oracle(xst[:2].double().cpu().numpy(), chain)
    oracle_check("streaming offline composition vs float64 oracle (2 ch)",
                 offline[:2], want, ORACLE_TOL)
    warm = chain.nfft // chain.hop - 1
    for block in STREAM_BLOCKS:
        name = f"streaming_north_star_block{block}"
        got = outs[name][..., warm:, :].cpu().numpy()
        assert got.shape == offline.shape, (name, got.shape, offline.shape)
        allclose_check(f"{name} + flush vs the offline composition (16 "
                       "ch, on the card)", got, offline, STREAM_TOL,
                       STREAM_TOL)
        oracle_check(f"{name} + flush vs float64 oracle (2 ch)", got[:2],
                     want, ORACLE_TOL)


def checkpoint_check(xst, chain) -> None:
    """The stream's state saved half way through the signal on the card
    and loaded back: the continuation equals the unbroken stream's bit for
    bit."""
    import tempfile
    from vv_dsp_tpu_torch.utils import checkpoint

    block = STREAM_BLOCKS[1]
    half = N_STREAM // 2 // block * block
    _, mid = chain.process_blocks(chain.init((CHANNELS,), device=xst.device),
                                  xst[:, :half], block)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.npz")
        checkpoint.save(path, mid)
        restored = checkpoint.load(path, chain.init((CHANNELS,),
                                                    device=xst.device))
    assert all(v.device == xst.device for v in restored.values())
    want, end = chain.process_blocks(mid, xst[:, half:], block)
    got, end2 = chain.process_blocks(restored, xst[:, half:], block)
    same = torch.equal(got, want) and all(torch.equal(end[k], end2[k])
                                          for k in end)
    print(f"checkpoint at sample {half} of {N_STREAM}, saved and loaded on "
          f"the card: the continuation's {got.shape[-2]} frames bit-equal "
          f"to the unbroken stream's: {same}")
    if not same:
        raise AssertionError("the checkpointed stream diverges")


def analysis_rows(paths, card: str) -> None:
    """Each row's CUDA-event time, wall time a call (and a block for the
    streams), input-rate Msamples/s, and the device's busy time and idle
    share under torch.profiler (the union of its kernel, memcpy and memset
    intervals, against the wall time of the profiled calls)."""
    from vv_dsp_tpu_torch.tools.profile_path import busy_us, device_events

    rows = {"iir_butter4": (CHANNELS, N_CHAIN, 1),
            "hilbert_envelope": (CHANNELS, N_CHAIN, 1),
            "czt_4096_dft_equiv": (CHANNELS, CZT_M, 1),
            "czt_4096_batched": (CHANNELS * N_CHAIN // CZT_M, CZT_M, 1),
            "cepstrum_4096": (CHANNELS, CZT_M, 1),
            "lpc_16": (CHANNELS, N_CHAIN, 1),
            **{f"streaming_north_star_block{b}": (CHANNELS, N_STREAM,
                                                   N_STREAM // b)
               for b in STREAM_BLOCKS}}
    fns = {name: fn for name, fn, _ in paths}
    for name, (rows_, n, blocks) in rows.items():
        fn = fns[name]
        ms = cuda_ms(fn, reps=3 if blocks > 1 else REPS)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        calls = 2 if blocks > 1 else 10
        prof_wall, events = device_events(fn, calls)
        busy = busy_us(events) / 1e3 / calls
        idle = 1 - busy / (prof_wall * 1e3 / calls)
        per = (f", {wall / blocks:.4f} ms a block of {n // blocks}"
               if blocks > 1 else "")
        print(f"{name} {rows_ * n / ms / 1e3:.2f} Msamples/s (event "
              f"{ms:.4f} ms, wall {wall:.4f} ms{per}, device busy "
              f"{busy:.4f} ms, idle share {idle:.4f}, {rows_} x {n}) | "
              f"{card}")
        if blocks > 1 and idle > 0.5:
            print(f"  {name} is bound by the host: the device idles "
                  f"{idle:.2f} of the wall time, {wall / blocks:.4f} ms of "
                  f"host time a block of {n // blocks} samples")


def analysis_phase(xc, card: str) -> dict:
    """The analysis, IIR and streaming tier: drive each path with every
    launch counter zeroed just before it and read just after, check the
    outputs and a checkpoint, and time the rows. Returns each kernel's
    launches summed over the paths."""
    from vv_dsp_tpu_torch.models import StreamingNorthStar

    counters = kernel_counters()
    rng = np.random.default_rng(14)
    xst = torch.as_tensor(rng.standard_normal((CHANNELS, N_STREAM)),
                          dtype=torch.float32, device=xc.device)
    t = np.arange(N_CHAIN) / 48000.0
    tone = torch.as_tensor(np.cos(2 * np.pi * 1000.0 * t[None]
                                  + rng.uniform(0, 2 * np.pi, (CHANNELS, 1))),
                           dtype=torch.float32, device=xc.device)
    chain = StreamingNorthStar()
    for block in STREAM_BLOCKS:
        chain.validate_block(block)
    paths = analysis_paths(xc, xst, tone, chain)
    outs, launches = {}, dict.fromkeys(counters, 0)
    for name, fn, want in paths:
        for counted in counters.values():
            counted.launches = 0
        outs[name] = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in counters.items() if f.launches}
        print(f"launches [{name}]: {got}")
        if got != want:
            raise AssertionError(f"{name} launched {got}, expected {want}")
        for k, count in got.items():
            launches[k] += count
        vals = outs[name]
        vals = torch.view_as_real(vals) if vals.is_complex() else vals
        assert torch.isfinite(vals).all().item(), f"non-finite {name}"
    frames = 1 + (-(-(N_STREAM + chain._resampler._geometry[3])
                    * chain.up // chain.down) - chain.nfft
                  + chain.hop) // chain.hop
    for name, shape in (("iir_butter4", (CHANNELS, N_CHAIN)),
                        ("czt_4096_batched",
                         (CHANNELS * N_CHAIN // CZT_M, CZT_M)),
                        ("cepstrum_4096", (CHANNELS, CZT_M)),
                        ("lpc_16", (CHANNELS, 17)),
                        ("streaming_offline_composition",
                         (CHANNELS, frames, chain.n_mfcc))):
        assert tuple(outs[name].shape) == shape, (name, outs[name].shape)
    print(f"analysis launches, summed over the paths: "
          f"{ {k: v for k, v in launches.items() if v} }")
    analysis_checks(outs, xc, xst, tone, chain)
    checkpoint_check(xst, chain)
    analysis_rows(paths, card)
    return launches


def shard_devices() -> list:
    """The card's devices, repeated to SHARDS shards (8 logical shards on
    one card, as the JAX tests run 8 virtual CPU devices)."""
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(SHARDS)]


def sharded_paths(xc, xl, probe, chain, gate, mesh) -> list:
    """(name, fn, launches it must make, (rows, n) of its input) of each
    sharded path on one mesh. Every sharded STFT runs the full-nfft
    spectrum kernel once a shard."""
    from vv_dsp_tpu_torch import parallel as par
    from vv_dsp_tpu_torch.ops import iir
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np

    c, b = mesh.shape["channel"], mesh.shape["block"]
    tag = f"{c}x{b}"
    spectrum = {"stft_spectrum_stockham": c * b}
    h = design_lowpass_np(FILTER_TIER_TAPS, 0.3)
    sos = iir.butter_sos(4, 0.2)
    xl2 = xl + 2.0
    full, long_ = (CHANNELS, N_CHAIN), (CHANNELS, N_LONG)
    return [
        (f"sharded_chain_fused_{tag}", lambda: chain.apply_sharded(xc, mesh),
         spectrum, full),
        (f"sharded_chain_staged_{tag}",
         lambda: chain.apply_sharded(xc, mesh, fuse_halos=False), spectrum,
         full),
        (f"sharded_spectral_gate_{tag}", lambda: gate.apply_sharded(probe,
                                                                    mesh),
         spectrum, full),
        (f"sharded_fir_{FILTER_TIER_TAPS}_{tag}",
         lambda: par.fir_apply_sharded(h, xc, mesh), {}, full),
        (f"sharded_iir_butter4_{tag}",
         lambda: par.iir_apply_sharded(sos, xc, mesh), {}, full),
        (f"sharded_resample_poly_4_3_{tag}",
         lambda: par.resample_poly_sharded(xc, 4, 3, mesh), {}, full),
        (f"sharded_savgol_31_3_{tag}",
         lambda: par.savgol_filter_sharded(xc, *SAVGOL, mesh), {}, full),
        (f"sharded_filtfilt_fir_{FILTER_TIER_TAPS}_{tag}",
         lambda: par.filtfilt_fir_sharded(h, xc, mesh), {}, full),
        (f"sharded_hilbert_{tag}",
         lambda: par.hilbert_analytic_sharded(xl, mesh), {}, long_),
        (f"sharded_cepstrum_{tag}",
         lambda: par.cepstrum_real_sharded(xl2, mesh), {}, long_),
    ]


def sharded_checks(outs: dict, tag: str, xc, xl, probe, chain, gate,
                   dense_chain, oracles: dict) -> None:
    """Each sharded row against the dense port on the card: the chain at
    2e-3 of scale and its fused halos against its staged path at 2e-4
    (tests/test_parallel.py's limits), both also against the float64
    chain oracle at the reference's 5e-5 of max|MFCC| (2 channels); the
    gate against the dense gate and its float64 oracle at 5e-5 of scale
    (on the probe); the ops at the JAX suite's allclose tolerances."""
    from vv_dsp_tpu_torch.ops import envelope, fir, hilbert, iir, resample
    from vv_dsp_tpu_torch.ops import savgol
    from vv_dsp_tpu_torch.ops.fir import design_lowpass_np
    from vv_dsp_tpu_torch.parallel import ShardedTensor

    def host(t):
        t = t.gather() if isinstance(t, ShardedTensor) else t
        t = torch.view_as_real(t) if t.is_complex() else t
        return t.cpu().numpy().astype(np.float64)

    nf = dense_chain.shape[-2]
    fused = host(outs[f"sharded_chain_fused_{tag}"])
    staged = host(outs[f"sharded_chain_staged_{tag}"])
    want = host(dense_chain)
    for name, got in (("fused", fused), ("staged", staged)):
        oracle_check(f"sharded chain {name} {tag} vs dense chain",
                     got[:, :nf], want, SHARDED_CHAIN_TOL)
        oracle_check(f"sharded chain {name} {tag} vs float64 oracle (2 ch)",
                     got[:2, :nf], oracles["chain"], ORACLE_TOL)
    oracle_check(f"sharded chain fused {tag} vs staged", fused, staged,
                 FUSED_STAGED_TOL)
    got = host(outs[f"sharded_spectral_gate_{tag}"])
    oracle_check(f"sharded SpectralGate {tag} vs dense gate (probe)", got,
                 host(gate(probe)), ORACLE_TOL)
    oracle_check(f"sharded SpectralGate {tag} vs float64 oracle (probe, "
                 "2 ch)", got[:2], oracles["gate"], ORACLE_TOL)
    h = design_lowpass_np(FILTER_TIER_TAPS, 0.3)
    dense = (
        (f"sharded_fir_{FILTER_TIER_TAPS}_{tag}", fir.fir_apply(h, xc),
         SHARDED_FIR_TOL),
        (f"sharded_iir_butter4_{tag}",
         iir.iir_apply(iir.butter_sos(4, 0.2), xc), SHARDED_IIR_TOL),
        (f"sharded_resample_poly_4_3_{tag}", resample.resample_poly(xc, 4, 3),
         SHARDED_RESAMPLE_TOL),
        (f"sharded_savgol_31_3_{tag}", savgol.savgol_filter(xc, *SAVGOL),
         SHARDED_RESAMPLE_TOL),
        (f"sharded_filtfilt_fir_{FILTER_TIER_TAPS}_{tag}",
         fir.filtfilt_fir(h, xc), SHARDED_FILTFILT_TOL),
        (f"sharded_hilbert_{tag}", hilbert.hilbert_analytic(xl),
         SHARDED_FFT_TOL),
        (f"sharded_cepstrum_{tag}", envelope.cepstrum_real(xl + 2.0),
         SHARDED_FFT_TOL))
    for name, ref, tol in dense:
        allclose_check(f"{name} vs dense", host(outs[name]), host(ref), tol,
                       tol)


def sharded_kernel_rows(paths, check: bool = True) -> None:
    """Kernel 9 against its plain version on the very blocks the sharded
    spectrum paths give it (2048/512 on each chain shard's extended
    block, 1024/256 on each gate shard's): each such path runs once more
    with the blocks that reach ``parallel.ops.stft_local`` recorded, then
    the first shard's block and the last's (whose right halo is zeros)
    each go through stft_spectrum_stockham, its one launch counted, and
    stft_spectrum_stockham_plain at STOCKHAM_TOL of scale. Under several
    processes every rank runs the paths (their halos are collective) and
    only those with check compare the blocks of their own shards."""
    from vv_dsp_tpu_torch.ops import stockham_kernels as stk
    from vv_dsp_tpu_torch.parallel import ops as pops

    kernel = stk.stft_spectrum_stockham
    plain_fn = stk.stft_spectrum_stockham_plain
    local = pops.stft_local
    seen, failed = [], []

    def recording(ext, nfft, hop, window, nf_local, rfft=True):
        seen.append((ext.contiguous(), (nfft, hop, window, rfft)))
        return local(ext, nfft, hop, window, nf_local, rfft)

    for name, fn, want, _ in paths:
        if "stft_spectrum_stockham" not in want:
            continue
        seen.clear()
        pops.stft_local = recording
        try:
            fn()
        finally:
            pops.stft_local = local
        torch.cuda.synchronize()
        if len(seen) != want["stft_spectrum_stockham"]:
            raise AssertionError(f"{name}: {len(seen)} shard blocks, "
                                 f"expected {want}")
        if not check:
            continue
        for which, (x, args) in (("first", seen[0]), ("last", seen[-1])):
            kernel.launches = 0
            got = kernel(x, *args)
            torch.cuda.synchronize()
            if kernel.launches != 1:
                raise AssertionError(f"{name} {which} shard: "
                                     f"{kernel.launches} launches, "
                                     f"expected 1")
            label = (f"{name}, {which} shard's block {args[0]}/{args[1]} "
                     f"{tuple(x.shape)} -> {tuple(got.shape)}")
            r = record("stft_spectrum_stockham", label, got,
                       plain_fn(x, *args), STOCKHAM_TOL,
                       lambda: kernel(x, *args), lambda: plain_fn(x, *args),
                       failed)
            # the bound and torch.stft on the same block: the frames the
            # kernel writes, (nf - 1) * hop + nfft samples of the block
            nfft, hop, window, rfft = args
            nf = got.shape[1]
            span = (nf - 1) * hop + nfft
            xin = torch.nn.functional.pad(
                x, (0, max(0, span - x.shape[-1])))[..., :span]
            lib = lambda: torch.stft(xin, nfft, hop, window=window,
                                     center=False, onesided=rfft,
                                     return_complex=True)
            lib_ms = cuda_ms(lib)
            b = bound(4 * x.numel() + got.element_size() * got.numel(),
                      fft_flops(x.shape[0] * nf, nfft), F32_FLOP_PER_S)
            print(f"  [{label}] kernel {r['ms']:.4f} ms, torch.stft "
                  f"{lib_ms:.4f} ms (layout c, bins, frames), bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}: "
                  f"{4 * x.numel() / 1e6:.2f} MB in, "
                  f"{got.element_size() * got.numel() / 1e6:.2f} MB out)")
    if failed:
        raise AssertionError(f"kernel vs plain on sharded blocks: {failed}")


def chain_input(dev) -> torch.Tensor:
    """The chain's (CHANNELS, N_CHAIN) input, seed 0's first draw."""
    return torch.as_tensor(np.random.default_rng(0).standard_normal(
        (CHANNELS, N_CHAIN)), dtype=torch.float32, device=dev)


def sharded_inputs(dev) -> tuple:
    """The sharded phase's (CHANNELS, N_LONG) signal and its gate probe
    (float64 and on dev), from seed 15."""
    rng = np.random.default_rng(15)
    xl = torch.as_tensor(rng.standard_normal((CHANNELS, N_LONG)),
                         dtype=torch.float32, device=dev)
    probe64 = gate_probe(N_CHAIN, 15, channels=CHANNELS).astype(np.float64)
    return xl, probe64, torch.as_tensor(probe64, dtype=torch.float32,
                                        device=dev)


def sharded_phase(xc, chain, card: str, keep: dict) -> dict:
    """The sharded path at full width: every row on the (1, 8) and (2, 4)
    meshes of the card's devices repeated to 8 shards, each with the
    launch counters zeroed just before it and read just after, checked,
    then timed (CUDA events, wall, device busy and idle share under
    torch.profiler). Keeps each row's gathered output, event and wall
    time in keep (the multi-process phase's yardstick). Returns each kernel's
    launches summed over the paths."""
    from vv_dsp_tpu_torch import parallel as par
    from vv_dsp_tpu_torch.models import SpectralGate
    from vv_dsp_tpu_torch.tools.profile_path import busy_us, device_events

    counters = kernel_counters()
    dev = xc.device
    xl, probe64, probe = sharded_inputs(dev)
    gate = SpectralGate(device=dev)
    dense_chain = chain(xc)
    oracles = {"chain": chain_oracle(xc[:2].cpu().double().numpy(), chain),
               "gate": gate_oracle(probe64[:2], GATE_T)[0]}
    launches = dict.fromkeys(counters, 0)
    for shape in SHARD_MESHES:
        mesh = par.make_mesh(*shape, devices=shard_devices())
        tag = f"{shape[0]}x{shape[1]}"
        print(f"sharded phase: {mesh}")
        paths = sharded_paths(xc, xl, probe, chain, gate, mesh)
        outs = {}
        for name, fn, want, _ in paths:
            for counted in counters.values():
                counted.launches = 0
            outs[name] = fn()
            torch.cuda.synchronize()
            got = {k: f.launches for k, f in counters.items() if f.launches}
            print(f"launches [{name}]: {got}")
            if got != want:
                raise AssertionError(f"{name} launched {got}, expected "
                                     f"{want}")
            for k, count in got.items():
                launches[k] += count
            vals = outs[name].gather()
            keep[name] = {"out": vals}
            vals = torch.view_as_real(vals) if vals.is_complex() else vals
            assert torch.isfinite(vals).all().item(), f"non-finite {name}"
        sharded_checks(outs, tag, xc, xl, probe, chain, gate, dense_chain,
                       oracles)
        del outs
        sharded_kernel_rows(paths)
        for name, fn, _, (rows, n) in paths:
            ms = cuda_ms(fn, reps=3)
            keep[name]["event_ms"] = ms
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            wall = statistics.median(walls)
            keep[name]["wall_ms"] = wall
            prof_wall, events = device_events(fn, 2)
            busy = busy_us(events) / 1e3 / 2
            idle = 1 - busy / (prof_wall * 1e3 / 2)
            print(f"{name} {rows * n / ms / 1e3:.2f} Msamples/s (event "
                  f"{ms:.4f} ms, wall {wall:.4f} ms, device busy "
                  f"{busy:.4f} ms, idle share {idle:.4f}, {rows} x {n}, "
                  f"{SHARDS} shards on {torch.cuda.device_count()} "
                  f"device(s)) | {card}")
    print(f"sharded launches, summed over the paths: "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def sharded_tol(name: str) -> float:
    """The sharded phase's limit of a sharded row, of scale."""
    for prefix, tol in (("sharded_chain", SHARDED_CHAIN_TOL),
                        ("sharded_spectral_gate", ORACLE_TOL),
                        ("sharded_fir", SHARDED_FIR_TOL),
                        ("sharded_iir", SHARDED_IIR_TOL),
                        ("sharded_resample", SHARDED_RESAMPLE_TOL),
                        ("sharded_savgol", SHARDED_RESAMPLE_TOL),
                        ("sharded_filtfilt", SHARDED_FILTFILT_TOL),
                        ("sharded_hilbert", SHARDED_FFT_TOL),
                        ("sharded_cepstrum", SHARDED_FFT_TOL)):
        if name.startswith(prefix):
            return tol
    raise KeyError(name)


def child_env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


def mp_worker(spec: dict) -> None:
    """One rank of the multi-process phase (``chip_smoke.py --mp-worker
    SPEC``): joins the group, holds `shards` positions of the mesh on
    cuda:0, runs each sharded path once with the counters zeroed just
    before it (launches: kernel 9 once a shard of this process, a sharded
    STFT) and the bytes it sent counted, gathers its output (a collective;
    rank 0 saves it), then times it from barrier to barrier; the last
    rank holds kernel 9 to its plain version on its own shards' blocks."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import_port()
    import torch.distributed as dist

    from vv_dsp_tpu_torch import parallel as par
    from vv_dsp_tpu_torch.models import NorthStarChain, SpectralGate
    from vv_dsp_tpu_torch.parallel import comm

    rank, world = spec["rank"], spec["world"]
    par.initialize_distributed(spec["init"], world, rank,
                               timeout=MP_TIMEOUT_S)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    (c, b), shards = spec["shape"], spec["shards"]
    mesh = par.make_mesh(c, b, devices=[dev] * shards)
    xl, _, probe = sharded_inputs(dev)
    chain, gate = NorthStarChain(device=dev), SpectralGate(device=dev)
    paths = [(name, fn, {k: v * shards // (c * b) for k, v in want.items()},
              size) for name, fn, want, size in sharded_paths(
                  chain_input(dev), xl, probe, chain, gate, mesh)]
    counters = kernel_counters()

    def settle():
        torch.cuda.synchronize()
        dist.barrier()

    report = {"launches": {}, "bytes": {}, "wall_ms": {}}
    outs = {}
    for name, fn, want, _ in paths:
        for counted in counters.values():
            counted.launches = 0
        sent = comm.exchange.bytes
        settle()
        out = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in counters.items() if f.launches}
        if got != want:
            raise AssertionError(f"rank {rank} {name} launched {got}, "
                                 f"expected {want}")
        report["launches"][name] = got
        report["bytes"][name] = comm.exchange.bytes - sent
        full = out.gather()
        if rank == 0:
            outs[name] = full.cpu()
        del out, full
        walls = []
        for _ in range(MP_REPS):
            settle()
            t0 = time.perf_counter()
            fn()
            settle()
            walls.append((time.perf_counter() - t0) * 1e3)
        report["wall_ms"][name] = statistics.median(walls)
        print(f"rank {rank} {name}: launches {got}, sent "
              f"{report['bytes'][name]} B, wall {report['wall_ms'][name]:.4f}"
              f" ms", flush=True)
    sharded_kernel_rows(paths, check=rank == world - 1)
    if rank == 0:
        torch.save(outs, spec["out"])
    with open(spec["report"], "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def mp_layout(tmp: str, shape, world: int, shards: int) -> tuple:
    """Run one layout's workers; returns (each rank's report, rank 0's
    gathered outputs). Fails if a worker fails or outlives
    MP_TIMEOUT_S."""
    from vv_dsp_tpu_torch.tools import run_scaling_report

    tag = f"{shape[0]}x{shape[1]}_{world}proc"
    procs, logs = [], []
    for rank in range(world):
        spec = {"rank": rank, "world": world, "shape": shape,
                "shards": shards, "init": f"file://{tmp}/rdv_{tag}",
                "out": os.path.join(tmp, f"{tag}.pt"),
                "report": os.path.join(tmp, f"{tag}_{rank}.json")}
        logs.append(os.path.join(tmp, f"{tag}_{rank}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp-worker",
                 json.dumps(spec)], cwd=HERE, env=child_env(), stdout=log,
                stderr=subprocess.STDOUT))
    rcs = run_scaling_report.wait_all(procs, MP_TIMEOUT_S)
    for rank, path in enumerate(logs):
        with open(path) as f:
            for line in f:
                if "socket.cpp" not in line:
                    print(f"  [{tag} rank {rank}] {line.rstrip()}")
    if any(rcs):
        raise AssertionError(f"multiprocess {tag}: worker exit codes {rcs} "
                             f"(negative: killed after one failed or after "
                             f"{MP_TIMEOUT_S} s)")
    reports = []
    for rank in range(world):
        with open(os.path.join(tmp, f"{tag}_{rank}.json")) as f:
            reports.append(json.load(f))
    return reports, torch.load(os.path.join(tmp, f"{tag}.pt"))


def launch_multihost_run(tmp: str, card: str) -> None:
    """``vv_dsp_tpu_torch.tools.launch_multihost`` at N = 2 on the card at
    its defaults (16 channels, 10 s, staged chain): rank 0's lines and its
    JSON."""
    from vv_dsp_tpu_torch.tools import run_scaling_report

    port = run_scaling_report.free_port()
    out = os.path.join(tmp, "launch_multihost.json")
    procs, logs = [], []
    for pid in range(2):
        logs.append(os.path.join(tmp, f"launch_multihost_{pid}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "vv_dsp_tpu_torch.tools."
                 "launch_multihost", "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", "2", "--process-id", str(pid),
                 "--json-out", out], cwd=HERE, env=child_env(), stdout=log,
                stderr=subprocess.STDOUT))
    rcs = run_scaling_report.wait_all(procs, MP_TIMEOUT_S)
    with open(logs[0]) as f:
        lines = [ln.rstrip() for ln in f if "socket.cpp" not in ln]
    for line in lines:
        print(f"  [launch_multihost rank 0] {line}")
    if any(rcs):
        raise AssertionError(f"launch_multihost N=2: exit codes {rcs}")
    with open(out) as f:
        got = json.load(f)
    if (got["n_processes"], got["n_devices"], got["samples"]) != (2, 2,
                                                                  N_CHAIN):
        raise AssertionError(f"launch_multihost N=2: {got}")
    print(f"launch_multihost N=2 on the card: {json.dumps(got)} | {card}")


def mp_phase(keep: dict, card: str) -> dict:
    """The sharded set in several processes on the card, each layout's
    gathered outputs held to the sharded phase's (keep) at its limits;
    then launch_multihost at N = 2. Returns each kernel's launches summed
    over the workers and paths."""
    import shutil
    import tempfile

    counters = kernel_counters()
    launches = dict.fromkeys(counters, 0)
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_", dir=build)
    dev = torch.device("cuda", 0)
    failed = []
    try:
        for shape, world, shards in MP_LAYOUTS:
            tag = f"{shape[0]}x{shape[1]}"
            reports, outs = mp_layout(tmp, shape, world, shards)
            for name, got in outs.items():
                want = keep[name]["out"]
                got = got.to(dev)
                if got.is_complex():
                    got, want = torch.view_as_real(got), torch.view_as_real(
                        want)
                err, rel = rel_err(got, want)
                tol = sharded_tol(name)
                per_rank = [r["launches"][name] for r in reports]
                for r in per_rank:
                    for k, count in r.items():
                        launches[k] += count
                crossed = sum(r["bytes"][name] for r in reports)
                print(f"multiprocess {name} as {world} processes x {shards}"
                      f" shards: wall {reports[0]['wall_ms'][name]:.4f} ms a"
                      f" call (barrier to barrier, median of {MP_REPS}), "
                      f"single process: event "
                      f"{keep[name]['event_ms']:.4f} ms, wall "
                      f"{keep[name]['wall_ms']:.4f} ms; "
                      f"{crossed} B crossed processes a call; "
                      f"launches per rank {per_rank}; against the single "
                      f"process {err:.3e}, {rel:.3e} of scale (limit "
                      f"{tol:g}) {'ok' if rel <= tol else 'FAIL'} | {card}")
                if not rel <= tol:
                    failed.append(f"{name} {tag}")
            del outs
        launch_multihost_run(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise AssertionError(f"multiprocess vs single process: {failed}")
    print(f"multiprocess launches, summed over the workers and paths: "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def io_phase(chain, card: str) -> dict:
    """The WAV serving flow: N_WAV seeded 16-bit mono clips of N_CHAIN
    samples written to a temporary directory under the checkout's build/,
    decoded in one batch by both backends (bit-equal, and equal to the
    16-bit quantization of the source), moved to the card and fed to
    NorthStarChain (bit-equal to the chain on the clips read one by one);
    then WAV -> SpectralGate -> write_wav -> read_wav, held to the gate's
    output at 16-bit quantization. Counters as in the slice phase.
    Returns each kernel's launches summed over the flows."""
    import tempfile
    from vv_dsp_tpu_torch import io as tio
    from vv_dsp_tpu_torch.io import wav as twav
    from vv_dsp_tpu_torch.models import SpectralGate

    counters = kernel_counters()
    launches = dict.fromkeys(counters, 0)
    dev = chain.head_taps.device
    rng = np.random.default_rng(16)
    clips = rng.uniform(-0.5, 0.5, (N_WAV, N_CHAIN)).astype(np.float32)
    quantized = (np.clip(np.rint(clips.astype(np.float64) * 32768.0),
                         -32768, 32767) / 32768.0).astype(np.float32)
    gate = SpectralGate(device=dev)

    def counted(name, fn, want):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in counters.items() if f.launches}
        print(f"launches [{name}]: {got}")
        if got != want:
            raise AssertionError(f"{name} launched {got}, expected {want}")
        for k, count in got.items():
            launches[k] += count
        return out

    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        paths = [os.path.join(tmp, f"clip{i:02d}.wav") for i in range(N_WAV)]
        for p, clip in zip(paths, clips):
            tio.write_wav(p, clip, 48000, format=16)
        if twav._get_lib() is None:
            raise AssertionError("the native WAV codec did not build")
        batches = {}
        for backend in ("native", "numpy"):
            saved = twav._get_lib
            if backend == "numpy":
                twav._get_lib = lambda: None
            try:
                secs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    batches[backend] = tio.read_wav_batch(paths)
                    secs.append(time.perf_counter() - t0)
            finally:
                twav._get_lib = saved
            sec = statistics.median(secs)
            print(f"io decode {backend} {N_WAV * N_CHAIN / sec / 1e6:.2f} "
                  f"Msamples/s (read_wav_batch of {N_WAV} 16-bit mono "
                  f"clips of {N_CHAIN} samples on the host, median of 3: "
                  f"{sec * 1e3:.2f} ms) | {card}")
        batch = batches["native"]
        if not torch.equal(batch.data, batches["numpy"].data):
            raise AssertionError("the two decode backends disagree")
        if not (batch.ok and (batch.frames == N_CHAIN).all().item()
                and (batch.rates == 48000).all().item()):
            raise AssertionError(f"batch decode: frames {batch.frames}, "
                                 f"rates {batch.rates}")
        decoded = batch.data[:, 0]
        if not np.array_equal(decoded.numpy(), quantized):
            raise AssertionError("decoded clips differ from the source's "
                                 "16-bit quantization")
        feats = counted("io_wav_batch_chain",
                        lambda: chain(decoded.to(dev)),
                        {"upfirdn_banded": 1, "stft_mfcc": 1})
        one_by_one = torch.stack([tio.read_wav(p)[0][0] for p in paths])
        same = torch.equal(feats, chain(one_by_one.to(dev)))
        print(f"io: the WAV-fed chain {tuple(feats.shape)} bit-equal to the "
              f"chain on the clips read one by one: {same}")
        if not same:
            raise AssertionError("the WAV-fed chain differs")
        y = counted("io_wav_spectral_gate", lambda: gate(decoded.to(dev)),
                    {"stft_spectrum": 1, "istft": 1})
        out = os.path.join(tmp, "gated.wav")
        tio.write_wav(out, y, 48000, format=16)
        back, sr = tio.read_wav(out)
        y64 = y.cpu().double().numpy()
        want = np.clip(np.rint(y64 * 32768.0), -32768, 32767) / 32768.0
        err = np.abs(back.double().numpy() - y64).max()
        exact = np.array_equal(back.numpy(), want.astype(np.float32))
        print(f"io: WAV -> SpectralGate -> write_wav -> read_wav "
              f"{tuple(back.shape)} at {sr} Hz: max |read - gate| "
              f"{err:.3e} (limit 0.5/32768 = {0.5 / 32768:.3e}), the "
              f"16-bit quantization of the gate's output bit for bit: "
              f"{exact}")
        if not (exact and err <= 0.5 / 32768 and sr == 48000):
            raise AssertionError("the gated WAV differs from the gate's "
                                 "output at 16-bit quantization")
    return launches


def tool_cases(d: str) -> list:
    """(label, tool, argv, tolerance, stdin file) of the tools phase: every
    tool on fixture files written from a seed into d."""
    rng = np.random.default_rng(21)
    reals = (rng.random(4096) * 2 - 1).astype(np.float32)
    cplx = (rng.random(1024) + 1j * rng.random(1024)).astype(np.complex64)
    files = {"reals": [f"{v:.9g}" for v in reals],
             "complex": [f"{v.real:.9g},{v.imag:.9g}" for v in cplx],
             "half": [f"{v.real:.9g},{v.imag:.9g}"
                      for v in np.fft.rfft(reals[:1024])]}
    for name, lines in files.items():
        with open(os.path.join(d, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    f = {k: os.path.join(d, f"{k}.txt") for k in files}
    w = np.exp(-2j * math.pi / 256)
    fft_t, filt_t = TOOL_FFT_TOL, TOOL_FILTER_TOL
    return [
        ("c2c fwd 1024", "dump_fft", ["--type", "c2c", "-n", "1024",
                                      "--infile", f["complex"]], fft_t, None),
        ("c2c inv 1000", "dump_fft", ["--type", "c2c", "--dir", "inv", "-n",
                                      "1000", "--infile", f["complex"]],
         fft_t, None),
        ("r2c 4096", "dump_fft", ["--type", "r2c", "-n", "4096", "--infile",
                                  f["reals"]], fft_t, None),
        ("c2r 1024", "dump_fft", ["--type", "c2r", "--dir", "inv", "-n",
                                  "1024", "--infile", f["half"]], fft_t,
         None),
        ("dct2 fwd 1000", "dump_dct", ["--type", "2", "-n", "1000",
                                       "--infile", f["reals"]], fft_t, None),
        ("dct2 inv 1024", "dump_dct", ["--type", "2", "--dir", "inv", "-n",
                                       "1024", "--infile", f["reals"]],
         fft_t, None),
        ("dct4 fwd 512", "dump_dct", ["--type", "4", "-n", "512",
                                      "--infile", f["reals"]], fft_t, None),
        ("czt 256", "dump_czt", ["--N", "256", "--M", "256", "--Wre",
                                 str(w.real), "--Wim", str(w.imag),
                                 "--infile", f["reals"]], fft_t, None),
        ("czt complex zoom", "dump_czt", ["--N", "1024", "--M", "128",
                                          "--Wre", str(math.cos(0.001)),
                                          "--Wim", str(-math.sin(0.001)),
                                          "--Are", "0.8", "--Aim", "0.6",
                                          "--infile", f["complex"],
                                          "--complex"], fft_t, None),
        ("hilbert 4096", "dump_hilbert", ["-n", "4096", "--fs", "48000",
                                          "--f", "1000", "--phase", "0.3"],
         fft_t, None),
        ("autocorr 2048", "dump_stats", ["autocorr", "2048", "0"], fft_t,
         f["reals"]),
        ("fir 255 taps", "dump_fir", ["--num-taps", "255", "--cutoff", "0.2",
                                      "--win", "hann", "--n", "4096",
                                      "--infile", f["reals"]], filt_t, None),
        ("fir coeffs 255", "dump_fir_coeffs", ["--num-taps", "255",
                                               "--cutoff", "0.2", "--win",
                                               "blackman"], filt_t, None),
        ("biquad 4096", "dump_iir", ["--b0", "0.2929", "--b1", "0.5858",
                                     "--b2", "0.2929", "--a1", "-0.0",
                                     "--a2", "0.1716", "--n", "4096",
                                     "--infile", f["reals"]], filt_t, None),
        ("linear 3/2", "dump_resample", ["--num", "3", "--den", "2",
                                         "--quality", "linear", "--infile",
                                         f["reals"]], filt_t, None),
        ("sinc:32 2/1", "dump_resample", ["--num", "2", "--den", "1",
                                          "--quality", "sinc:32", "--infile",
                                          f["reals"]], filt_t, None),
        ("stft roundtrip 1024/256", "dump_stft_roundtrip",
         ["--fft", "1024", "--hop", "256", "--win", "hann", "--n", "4096",
          "--infile", f["reals"]], fft_t, None),
        ("mfcc", "dump_mfcc", [], fft_t, None),
        ("mfcc 2048/80/20", "dump_mfcc", ["--n-fft", "2048", "--n-mels",
                                          "80", "--n-mfcc", "20",
                                          "--sample-rate", "48000"], fft_t,
         None),
    ]


def run_tool(tool: str, argv: list, stdin_path) -> tuple[int, str, str]:
    """(rc, stdout, stderr) of a port tool's main(argv), in this process."""
    import importlib
    import io
    mod = importlib.import_module(f"vv_dsp_tpu_torch.tools.{tool}")
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    if stdin_path:
        with open(stdin_path) as f:
            sys.stdin = io.StringIO(f.read())
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = mod.main(list(argv))
    finally:
        sys.stdin = saved
    return rc, out.getvalue(), err.getvalue()


def tool_values(out: str) -> np.ndarray:
    """Every number on every line of a tool's stdout that is not a '#'
    header ('re,im' gives two)."""
    return np.asarray([float(v) for line in out.splitlines()
                       if line.strip() and not line.startswith("#")
                       for v in line.replace(",", " ").split()])


def ola_norm64(argv: list) -> np.ndarray:
    """dump_stft_roundtrip's w^2 overlap-add norm in float64."""
    from vv_dsp_tpu_torch.ops.window import get_window_np
    flags = dict(zip(argv[::2], argv[1::2]))
    nfft, hop, n = int(flags["--fft"]), int(flags["--hop"]), int(flags["--n"])
    w2 = get_window_np(flags["--win"], nfft) ** 2
    norm = np.zeros(n)
    for i in range(0 if n < nfft else (n - nfft) // hop + 1):
        norm[i * hop:i * hop + nfft] += w2
    return norm


def mfcc_limit(want: np.ndarray) -> float:
    """The MFCC limit of a card run against a CPU run: 5e-4 absolute or
    MFCC_TOL of scale, whichever is larger (tests/test_torch_cuda.py)."""
    return max(MFCC_ATOL, MFCC_TOL * float(np.abs(want).max()))


def example_checks(name: str, card: dict, cpu: dict) -> list:
    """(label, reading, limit) of one example twin's card run against its
    CPU run; a reading over its limit fails."""
    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / np.abs(b).max())

    def absolute(a, b):
        return float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())

    if name == "stft_pipeline":
        return [("gated signal card vs CPU, of scale",
                 rel(card["y"], cpu["y"]), SPECTRUM_TOL),
                ("SNR out card vs CPU, dB",
                 abs(card["snr_out"] - cpu["snr_out"]), 0.1)]
    if name == "wav_mfcc":
        return [("card MFCC from float64, limit twice the CPU's",
                 absolute(card["feats"], cpu["oracle"]),
                 2 * absolute(cpu["feats"], cpu["oracle"])),
                ("c0 mean card vs CPU", abs(card["c0_mean"] - cpu["c0_mean"]),
                 mfcc_limit(cpu["feats"]))]
    if name == "serving":
        return [(f"batch {i} MFCC card vs CPU", absolute(a, b),
                 mfcc_limit(b))
                for i, (a, b) in enumerate(zip(card["feats"],
                                               cpu["feats"]))]
    if name == "filter":
        return [(f"{k} card vs CPU, of max |y|", rel(card[k], cpu[k]),
                 TOOL_FILTER_TOL)
                for k in ("y", "filtfilt", "butter")] + [
            ("streamed FIR vs whole on the card", card["stream_diff"],
             1e-6)]
    if name == "precision":
        return [("highest MFCC card vs CPU",
                 absolute(card["ref"], cpu["ref"]),
                 mfcc_limit(cpu["ref"]))] + [
            (f"{tier} vs highest on the card", card["errors"][tier],
             TIER_BOUNDS[tier]) for tier in TIER_BOUNDS]
    return [("sharded FIR vs dense on the card", card["fir_err"],
             SHARDED_FIR_TOL),
            ("sharded IIR vs dense on the card", card["iir_err"],
             SHARDED_IIR_TOL),
            ("sharded chain MFCC card vs CPU",
             absolute(card["feats"], cpu["feats"]),
             mfcc_limit(cpu["feats"]))]


def tools_phase(chain, xc, card: str) -> dict:
    """The port's user surfaces on the card: every CLI tool on fixture
    files from a seed, on the card and again with --cpu, held to each
    other (each launching no kernel: the tools run the plain entry
    points); bench_czt 4096 4096 20 on the card (Peak bin: 37); the six
    example twins at their default sizes on the card, each with the
    counters zeroed just before it and read just after, and again on the
    CPU, held to each other; utils.profiling: the chain's BenchResult
    beside cuda_ms, detect_chip() == "h100", a Chrome trace of one chain
    call, and the chain's FIR, STFT and resampler rooflines against the
    same calls' times, each beside its section 6 bound. Returns each
    kernel's launches over the twins."""
    import importlib
    import tempfile
    from vv_dsp_tpu_torch.ops import filter_kernels as fk
    from vv_dsp_tpu_torch.ops.stft import STFT
    from vv_dsp_tpu_torch.utils import profiling

    counters = kernel_counters()
    launches = dict.fromkeys(counters, 0)
    failed = []
    dev, cpu = xc.device, torch.device("cpu")

    def counted(name, fn, want):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in counters.items() if f.launches}
        print(f"launches [{name}]: {got}")
        if got != want:
            failed.append(f"{name} launched {got}, expected {want}")
        return out, got

    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for label, tool, argv, tol, stdin in tool_cases(tmp):
            (rc, out, err), _ = counted(f"tool {tool} {label}",
                                        lambda: run_tool(tool, argv, stdin),
                                        {})
            rc_c, out_c, err_c = run_tool(tool, argv + ["--cpu"], stdin)
            got, want = tool_values(out), tool_values(out_c)
            if tool == "dump_stft_roundtrip":
                norm = ola_norm64(argv)
                got, want = got * norm, want * norm
            lines = (len(out.splitlines()), len(out_c.splitlines()))
            same = (rc == rc_c == 0 and lines[0] == lines[1]
                    and got.shape == want.shape and got.size > 0)
            scale = max(np.abs(got).max(), np.abs(want).max()) if same else 1
            reading = float(np.abs(got - want).max() / scale) if same else 1
            if same and tool == "dump_hilbert":  # avg_ifreq=%g Hz ...
                f_card = float(err.split("=")[1].split()[0])
                f_cpu = float(err_c.split("=")[1].split()[0])
                print(f"  avg_ifreq card {f_card:g} Hz, cpu {f_cpu:g} Hz")
                same = same and abs(f_card - f_cpu) <= tol * abs(f_cpu)
            elif err != err_c:
                same = False
            headers = [[l for l in o.splitlines() if l.startswith("#")]
                       for o in (out, out_c)]
            same = same and headers[0] == headers[1]
            ok = same and reading <= tol
            print(f"tool {tool} [{label}]: rc {rc}/{rc_c}, {lines[0]} lines, "
                  f"max diff card vs --cpu {reading:.3e} of scale (tol "
                  f"{tol:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"tool {tool} [{label}]")
        (rc, out, _), _ = counted("tool bench_czt",
                                  lambda: run_tool("bench_czt",
                                                   list(BENCH_CZT), None), {})
        for line in out.splitlines():
            print(f"{line} | {card}")
        if rc != 0 or "Peak bin: 37" not in out.splitlines():
            failed.append(f"bench_czt {' '.join(BENCH_CZT)}: rc {rc}")

    for name in ("stft_pipeline", "wav_mfcc", "serving", "filter",
                 "precision", "multichip"):
        mod = importlib.import_module(
            f"vv_dsp_tpu_torch.examples.{name}_example")
        t0 = time.perf_counter()
        card_res, got = counted(f"example {name}", lambda: mod.run(dev),
                                EXAMPLE_LAUNCHES[name])
        wall = time.perf_counter() - t0
        for k, count in got.items():
            launches[k] += count
        t0 = time.perf_counter()
        cpu_res = mod.run(cpu)
        cpu_wall = time.perf_counter() - t0
        if name == "wav_mfcc":
            cpu_res["oracle"] = frontend_oracle(
                cpu_res["audio"].double().numpy(), cpu_res["model"])
        print(f"example {name}: wall {wall * 1e3:.1f} ms on the card "
              f"({cpu_wall * 1e3:.1f} ms on the CPU) | {card}")
        for label, reading, limit in example_checks(name, card_res, cpu_res):
            ok = reading <= limit
            print(f"  {name} [{label}]: {reading:.3e} (limit {limit:.3e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"example {name} [{label}]")

    rec = profiling.benchmark("northstar_chain", chain, xc)
    print(f"profiling.benchmark {rec.to_json()} | cuda_ms "
          f"{cuda_ms(lambda: chain(xc)):.4f} | {card}")
    chip = profiling.detect_chip()
    print(f"profiling.detect_chip: {chip!r}")
    if chip != "h100":
        failed.append(f"detect_chip() = {chip!r} on {card}")
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        with profiling.trace(tmp):
            chain(xc)
            torch.cuda.synchronize()
        sizes = [os.path.getsize(os.path.join(tmp, f))
                 for f in os.listdir(tmp)]
        print(f"profiling.trace: {len(sizes)} file(s), {sum(sizes)} bytes")
        if len(sizes) != 1 or not sizes[0]:
            failed.append(f"trace wrote {sizes}")
    c, n = xc.shape
    h = chain.fir_coeffs
    head = len(h)
    y = fk.resample_poly_best(xc, chain.up, chain.down)
    spec = STFT(chain.nfft, chain.hop)
    spectrum = spec.process(y, rfft=False)
    frames = spectrum.shape[1]
    taps_pp = -(-(20 * max(chain.up, chain.down) + 1) // chain.up)
    # each roofline beside the section 6 bound of the same call (each input
    # read once, each output written once): profiling's STFT model, the
    # JAX package's, reads every overlapping frame from memory
    for label, roof, sec6, fn in (
            (f"fir {head} taps", profiling.fir_roofline(c, n, head, "h100"),
             bound(4 * (2 * xc.numel() + head), 2 * xc.numel() * head,
                   F32_FLOP_PER_S),
             lambda: fk.fir_apply_best(h, xc)),
            (f"stft {chain.nfft}/{chain.hop}",
             profiling.stft_roofline(c, frames, chain.nfft, "h100"),
             bound(4 * y.numel() + 8 * spectrum.numel(),
                   fft_flops(c * frames, chain.nfft), F32_FLOP_PER_S),
             lambda: spec.process(y, rfft=False)),
            (f"resample {chain.up}/{chain.down}",
             profiling.resample_roofline(c, y.shape[-1], taps_pp, n, "h100"),
             bound(4 * (xc.numel() + y.numel()),
                   2 * y.numel() * taps_pp, F32_FLOP_PER_S),
             lambda: fk.resample_poly_best(xc, chain.up, chain.down))):
        ms = cuda_ms(fn)
        print(f"profiling roofline [{label}] (the JAX package's byte "
              f"model): attainable {roof.attainable_seconds * 1e3:.4f} ms "
              f"({'compute' if roof.compute_bound else 'bandwidth'}-bound), "
              f"measured {ms:.4f} ms, achieved "
              f"{roof.achieved_fraction(ms / 1e3):.3f}; section 6 bound "
              f"{sec6['bound_ms']:.4f} ms ({sec6['bound_by']}), achieved "
              f"{sec6['bound_ms'] / ms:.3f} | {card}")
    if failed:
        raise AssertionError(f"tools phase: {failed}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import_port()
    from vv_dsp_tpu_torch.models import MFCCFrontend, NorthStarChain

    card = device_phase()

    log = build_phase()
    torch.cuda.synchronize()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    xc = torch.as_tensor(rng.standard_normal((CHANNELS, N_CHAIN)),
                         dtype=torch.float32, device=dev)
    xs = torch.as_tensor(rng.standard_normal((CHANNELS, N_STFT)),
                         dtype=torch.float32, device=dev)
    chain, front = NorthStarChain(device=dev), MFCCFrontend(device=dev)
    staged = NorthStarChain(fused_head=False, device=dev)
    front128 = MFCCFrontend(*SMALL, n_mels=26, n_mfcc=13, sample_rate=8000.0,
                            device=dev)
    kernels = kernel_phase(xc, xs, chain, front, front128, log)
    torch.cuda.synchronize()
    launches = slice_phase(xc, xs, chain, staged, front, front128, card)
    torch.cuda.synchronize()
    for name, count in analysis_phase(xc, card).items():
        launches[name] += count
    torch.cuda.synchronize()
    keep = {}
    for label, phase in (("sharded",
                          lambda: sharded_phase(xc, chain, card, keep)),
                         ("io", lambda: io_phase(chain, card)),
                         ("tools", lambda: tools_phase(chain, xc, card)),
                         ("multiprocess", lambda: mp_phase(keep, card))):
        t0 = time.perf_counter()
        for name, count in phase().items():
            launches[name] += count
        torch.cuda.synchronize()
        print(f"{label} phase: {time.perf_counter() - t0:.1f} s")

    sources = {
        "upfirdn_banded": ("vv_dsp_tpu_torch/csrc/upfirdn.cu",
                           "vv_dsp_tpu/ops/pallas_upfirdn.py:141"),
        "stft_mfcc": ("vv_dsp_tpu_torch/csrc/stft.cu",
                      "vv_dsp_tpu/ops/pallas_fft.py:350"),
        "stft_spectrum": ("vv_dsp_tpu_torch/csrc/stft.cu",
                          "vv_dsp_tpu/ops/pallas_fft.py:589"),
        "stft_power": ("vv_dsp_tpu_torch/csrc/stft.cu",
                       "vv_dsp_tpu/ops/pallas_fft.py:686"),
        "istft": ("vv_dsp_tpu_torch/csrc/istft.cu",
                  "vv_dsp_tpu/ops/pallas_fft.py:1090"),
        "stft_mel_stockham": ("vv_dsp_tpu_torch/csrc/stockham.cu",
                              "vv_dsp_tpu/ops/pallas_fft.py:1598"),
        "stft_power_stockham": ("vv_dsp_tpu_torch/csrc/stockham.cu",
                                "vv_dsp_tpu/ops/pallas_fft.py:1649"),
        "stft_spectrum_stockham": ("vv_dsp_tpu_torch/csrc/stockham.cu",
                                   "vv_dsp_tpu/ops/pallas_fft.py:1745"),
        "stft_gate_stockham": ("vv_dsp_tpu_torch/csrc/stockham.cu",
                               "vv_dsp_tpu/ops/pallas_fft.py:2210"),
        "fir_direct": ("vv_dsp_tpu_torch/csrc/filter.cu",
                       "vv_dsp_tpu/ops/pallas_kernels.py:101"),
        "poly_kernel": ("vv_dsp_tpu_torch/csrc/filter.cu",
                        "vv_dsp_tpu/ops/pallas_kernels.py:183"),
        "stft_power_dft": ("vv_dsp_tpu_torch/csrc/dft_power.cu",
                           "vv_dsp_tpu/ops/pallas_kernels.py:345"),
        "istft_stockham": ("vv_dsp_tpu_torch/csrc/stockham.cu",
                           "vv_dsp_tpu/ops/pallas_fft.py:2365"),
        "stft_gate_packed": ("vv_dsp_tpu_torch/csrc/gate_packed.cu",
                             "vv_dsp_tpu/ops/pallas_fft.py:2028"),
        "fir_os": ("vv_dsp_tpu_torch/csrc/fir_os.cu",
                   "none (vv_dsp_tpu/ops/fir.py:fir_apply_os is XLA rffts)"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **kernels[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-worker"]:
        mp_worker(json.loads(sys.argv[2]))
    else:
        main()
