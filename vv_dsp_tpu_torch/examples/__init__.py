"""Example scripts of the port (counterparts of the repo's ``examples/``,
same file names and inputs):

    python -m vv_dsp_tpu_torch.examples.<name>_example [--cpu]

``filter``, ``multichip``, ``precision``, ``serving``, ``stft_pipeline``
and ``wav_mfcc``. Each runs on the card unless ``--cpu`` is given (without
a GPU and without ``--cpu`` it writes ``no CUDA device; pass --cpu`` to
stderr and returns 1), and exposes ``run(device, ...)``, which prints what
the JAX example prints and returns the values it printed, and
``main(argv) -> int``.
"""

from __future__ import annotations

import argparse

from vv_dsp_tpu_torch.tools import _cli


def parse(argv, description: str, add_arguments=None):
    """(parsed args, the device or None): the common ``--cpu`` flag and
    the device rule of the tools (``tools._cli``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    if add_arguments is not None:
        add_arguments(ap)
    args = ap.parse_args(argv)
    return args, _cli.open_device("cpu" if args.cpu else "cuda")
