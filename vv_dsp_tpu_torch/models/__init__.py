"""Pipelines of the port (counterparts of vv_dsp_tpu.models)."""

from vv_dsp_tpu_torch.models.pipeline import (MFCCFrontend, NorthStarChain,
                                              SpectralGate, chain_params,
                                              frontend_params)

__all__ = ["MFCCFrontend", "NorthStarChain", "SpectralGate", "chain_params",
           "frontend_params"]
