"""WAV -> MFCC features (counterpart of examples/wav_mfcc_example.py and of
the reference's tools/dump_mfcc.c on the voicebank fixture): synthesizes a
WAV, decodes it with the native codec, and extracts MFCCs with
MFCCFrontend(512, 256, 26 mels, 13 MFCCs), the packed MFCC kernel on the
card.

    python -m vv_dsp_tpu_torch.examples.wav_mfcc_example [--cpu]
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from vv_dsp_tpu_torch.examples import parse
from vv_dsp_tpu_torch.io import read_wav, wav_info, write_wav
from vv_dsp_tpu_torch.models import MFCCFrontend


def run(device) -> dict:
    fs = 16000
    t = np.arange(fs) / fs
    sig = (0.5 * np.sin(2 * np.pi * 220 * t)
           + 0.25 * np.sin(2 * np.pi * 660 * t)).astype(np.float32)

    with tempfile.TemporaryDirectory(prefix="vvdsp_example_") as tmp:
        path = os.path.join(tmp, "vvdsp_example.wav")
        write_wav(path, sig, fs, format=16)
        info = wav_info(path)
        print(f"wrote {path}: {info.sample_rate} Hz, {info.channels} ch, "
              f"{info.bits}-bit, {info.frames} frames")
        audio, sr = read_wav(path)
    model = MFCCFrontend(nfft=512, hop=256, n_mels=26, n_mfcc=13,
                         sample_rate=float(sr), lifter=22.0, device=device)
    feats = model(audio.to(device)).cpu().numpy()
    c0_mean = float(np.mean(feats[..., 0]))
    print("MFCC:", feats.shape, "c0 mean:", c0_mean)
    return {"feats": feats, "c0_mean": c0_mean, "audio": audio,
            "model": model}


def main(argv=None) -> int:
    _, dev = parse(argv, __doc__)
    if dev is None:
        return 1
    run(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
