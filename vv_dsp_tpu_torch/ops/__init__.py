"""Signal-processing ops of the port (counterparts of vv_dsp_tpu.ops)."""
