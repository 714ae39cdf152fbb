"""Utilities of the port (counterparts of vv_dsp_tpu.utils)."""
