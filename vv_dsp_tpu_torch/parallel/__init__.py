"""The sharded path: mesh set-up, halo exchange and sharded DSP ops over a
(channel, block) mesh of devices (counterpart of
``vv_dsp_tpu/parallel``).

Mesh convention, as the JAX package's: a 2-D mesh ``("channel", "block")``
with
  - ``channel``: the embarrassingly parallel data axis (channels, batch),
  - ``block``: the time axis cut into contiguous blocks, whose seams take
    neighbour halo exchanges.

One process drives every device of the mesh (``jax.shard_map`` is
single-controller too); a device may repeat, so one card holds any number
of shards (``mesh.py``). A sharded result is a ``ShardedTensor``, whose
``gather`` gives the global tensor.
"""

from vv_dsp_tpu_torch.parallel.mesh import (Mesh, block_size,
                                            initialize_distributed,
                                            make_mesh, pad_to_blocks)
from vv_dsp_tpu_torch.parallel.sharded import ShardedTensor, shard
from vv_dsp_tpu_torch.parallel.halo import halo_from_left, halo_from_right
from vv_dsp_tpu_torch.parallel.ops import (
    fir_apply_sharded,
    iir_apply_sharded,
    stft_process_sharded,
    stft_reconstruct_sharded,
    resample_poly_sharded,
    savgol_filter_sharded,
    filtfilt_fir_sharded,
    shard_channels,
)
from vv_dsp_tpu_torch.parallel.fft import (
    fft_sharded,
    ifft_sharded,
    hilbert_analytic_sharded,
    cepstrum_real_sharded,
)

__all__ = ["Mesh", "ShardedTensor", "block_size", "cepstrum_real_sharded",
           "fft_sharded", "filtfilt_fir_sharded", "fir_apply_sharded",
           "halo_from_left", "halo_from_right", "hilbert_analytic_sharded",
           "ifft_sharded", "iir_apply_sharded", "initialize_distributed",
           "make_mesh", "pad_to_blocks", "resample_poly_sharded",
           "savgol_filter_sharded", "shard", "shard_channels",
           "stft_process_sharded", "stft_reconstruct_sharded"]
