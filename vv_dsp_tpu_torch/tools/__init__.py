"""Command-line tools of the port (counterparts of ``vv_dsp_tpu.tools``).

The 12 dump/bench tools in ``TOOLS`` keep the JAX tools' flags, stdout
formats, stderr messages and exit codes, so the reference's validators
(python/test_*.py) can drive the port by swapping the binary path for
``python -m vv_dsp_tpu_torch.tools.<tool>`` (or the ``vv-dsp-torch``
dispatcher). Each module exposes ``main(argv) -> int`` and is runnable
with ``-m``. Each runs on the card unless ``--cpu`` is given anywhere in
its arguments; without a GPU and without ``--cpu`` it writes
``no CUDA device; pass --cpu`` to stderr and returns 1 (``_cli``).

Beside them: ``profile_path`` (where the main path's device time goes),
``poly_ratios`` and ``poly_floor`` (the per-phase resampler's timings),
and the two launchers in ``LAUNCHERS``, twins of the JAX package's
``scripts/launch_multihost.py`` (one program in N processes over a global
mesh) and ``scripts/run_scaling_report.py`` (the weak-scaling sweep over
N of them), which the dispatcher runs too.
"""

TOOLS = [
    "dump_fft", "dump_fir", "dump_fir_coeffs", "dump_iir",
    "dump_stft_roundtrip", "dump_resample", "dump_czt", "dump_dct",
    "dump_stats", "dump_hilbert", "dump_mfcc", "bench_czt",
]
LAUNCHERS = ["launch_multihost", "run_scaling_report"]
