"""Pipelines of the port (counterparts of vv_dsp_tpu.models)."""

from vv_dsp_tpu_torch.models.pipeline import NorthStarChain, chain_params

__all__ = ["NorthStarChain", "chain_params"]
