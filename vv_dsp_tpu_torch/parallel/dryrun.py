"""Run the whole sharded set once on an n-shard mesh at tiny shapes
(counterpart of ``__graft_entry__.dryrun_multichip``):

    python -m vv_dsp_tpu_torch.parallel.dryrun [n_shards] [--cpu]

It drives every cross-shard mechanism the package has: the FIR's left
halo, the polyphase two-sided halo, the STFT's right halo and frame
sharding, the channel axis, the IIR's composition of the shards' affine
maps, the distributed FFT's cross-shard DFT, the overlap-add spill of the
synthesis seam and the edge-padded two-sided halos of savgol and
filtfilt, and checks each output's shape. It runs in one process, which
owns every position of the mesh; the same set across processes, each
owning some positions, is tests/test_torch_multiprocess.py's and
chip_smoke.py's multiprocess phase.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vv_dsp_tpu_torch.models import NorthStarChain
from vv_dsp_tpu_torch.ops import iir as _iir
from vv_dsp_tpu_torch.parallel import mesh as _mesh
from vv_dsp_tpu_torch.parallel import ops as _ops
from vv_dsp_tpu_torch.parallel import fft as _pfft


def dryrun_multichip(n_shards: int, device=None) -> None:
    """n_shards shards over the CUDA devices in turn (raising without
    one), or all on `device` when given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu'")
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n_shards)]
    else:
        devices = [torch.device(device)] * n_shards
    n_channel = 2 if n_shards % 2 == 0 and n_shards > 1 else 1
    n_block = n_shards // n_channel
    mesh = _mesh.make_mesh(n_channel, n_block, devices=devices)
    dev = devices[0]

    # a tiny chain: each block divides by `down`, each resampled block by
    # the hop
    chain = NorthStarChain(fir_taps=64, up=4, down=3, nfft=256, hop=64,
                           n_mels=32, n_mfcc=13, device=dev)
    t_local = 192 * 4
    n = n_block * t_local
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2 * n_channel, n)), dtype=torch.float32)

    out = chain.apply_sharded(x, mesh)
    assert out.shape[-1] == chain.n_mfcc, out.shape
    y = _ops.iir_apply_sharded(_iir.butter_sos(4, 0.25), x, mesh)
    assert y.shape == x.shape
    z = _pfft.hilbert_analytic_sharded(x, mesh)
    assert z.shape == x.shape
    spec = _ops.stft_process_sharded(x, 256, 64, mesh)
    w = _ops.stft_reconstruct_sharded(spec, 256, 64, mesh)
    assert w.shape == x.shape, w.shape
    r = _ops.resample_poly_sharded(x, 4, 3, mesh)
    assert r.shape[-1] == n * 4 // 3
    h = np.hanning(17) / np.hanning(17).sum()
    f = _ops.filtfilt_fir_sharded(h.astype(np.float32), x, mesh)
    assert f.shape == x.shape
    s = _ops.savgol_filter_sharded(x, 31, 3, mesh)
    assert s.shape == x.shape
    for t in (out, y, z, w, r, f, s):
        vals = t.gather()
        vals = torch.view_as_real(vals) if vals.is_complex() else vals
        assert torch.isfinite(vals).all().item()


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    cpu = "--cpu" in sys.argv[1:]
    shards = int(args[0]) if args else (
        8 if cpu else torch.cuda.device_count())
    dryrun_multichip(shards, device="cpu" if cpu else None)
    print(f"dryrun ok: {shards} shards")
