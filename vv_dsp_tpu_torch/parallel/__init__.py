"""The sharded path: mesh set-up, halo exchange and sharded DSP ops over a
(channel, block) mesh of devices (counterpart of
``vv_dsp_tpu/parallel``).

Mesh convention, as the JAX package's: a 2-D mesh ``("channel", "block")``
with
  - ``channel``: the embarrassingly parallel data axis (channels, batch),
  - ``block``: the time axis cut into contiguous blocks, whose seams take
    neighbour halo exchanges.

One process drives every device of the mesh unless several processes
run the program (``initialize_distributed``, SPMD as under
``jax.distributed``): then each process owns the mesh positions of the
devices it passed ``make_mesh``, holds only those shards and issues only
their work, and halos, the IIR's offsets and the block DFT's blocks cross
processes through host memory over gloo (``comm.py``). A device may
repeat, so one card holds any number of shards, of one process or of
several (``mesh.py``). A sharded result is a ``ShardedTensor``, whose
``gather`` gives the global tensor (a collective across processes).
"""

from vv_dsp_tpu_torch.parallel.mesh import (Mesh, block_size,
                                            initialize_distributed,
                                            make_mesh, pad_to_blocks,
                                            process_count, process_index)
from vv_dsp_tpu_torch.parallel.sharded import Row, ShardedTensor, shard
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

__all__ = ["Mesh", "Row", "ShardedTensor", "block_size",
           "cepstrum_real_sharded", "fft_sharded", "filtfilt_fir_sharded",
           "fir_apply_sharded", "halo_from_left", "halo_from_right",
           "hilbert_analytic_sharded", "ifft_sharded", "iir_apply_sharded",
           "initialize_distributed", "make_mesh", "pad_to_blocks",
           "process_count", "process_index", "resample_poly_sharded",
           "savgol_filter_sharded", "shard", "shard_channels",
           "stft_process_sharded", "stft_reconstruct_sharded"]
