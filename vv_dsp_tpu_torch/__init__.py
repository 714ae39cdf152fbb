"""vv_dsp_tpu_torch: the PyTorch + CUDA port of vv_dsp_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every TPU kernel on the ported path is a
hand-written CUDA kernel (``csrc/``), built with nvcc on first use
(``_build.py``). Tensors on the CPU run each kernel's plain PyTorch version.
This package never imports jax.
"""

__version__ = "0.1.0"
