"""Command-line tools of the port (counterparts of vv_dsp_tpu.tools)."""
