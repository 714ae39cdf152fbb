"""Dispatcher: ``python -m vv_dsp_tpu_torch.tools <tool> [args...] [--cpu]``
(the ``vv-dsp-torch`` script)."""

import importlib
import sys

from vv_dsp_tpu_torch.tools import LAUNCHERS, TOOLS


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in TOOLS + LAUNCHERS:
        sys.stderr.write("usage: python -m vv_dsp_tpu_torch.tools <tool> "
                         "[args...] [--cpu]\n"
                         "tools: " + " ".join(TOOLS) + "\n"
                         "launchers: " + " ".join(LAUNCHERS) + "\n")
        return 2
    mod = importlib.import_module(f"vv_dsp_tpu_torch.tools.{argv[0]}")
    return mod.main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
