"""Host-side audio I/O (WAV), counterpart of ``vv_dsp_tpu/io``. Decoding
is host work: tensors come back on the CPU, and land on the card only when
the caller moves them there."""

from vv_dsp_tpu_torch.io.wav import WavInfo, read_wav, wav_info, write_wav
from vv_dsp_tpu_torch.io.batch import (WavBatch, prefetch_batches,
                                       read_wav_batch)

__all__ = ["WavBatch", "WavInfo", "prefetch_batches", "read_wav",
           "read_wav_batch", "wav_info", "write_wav"]
