"""Minimal file-to-file super-resolution with the port — counterpart of the
repository's root ``example.py``:

    python -m flowhigh_tpu_torch.example input.wav output.wav [CKPT_DIR]

With ``CKPT_DIR`` the published checkpoint files are read from there
(``FlowHighSR.from_local``); without it they are fetched from the hub
(``from_pretrained``, network access). Runs on the card."""

from __future__ import annotations

import sys

import numpy as np
import scipy.io.wavfile as wavfile

from .sr import FlowHighSR


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    in_path = argv[0] if len(argv) > 0 else "input.wav"
    out_path = argv[1] if len(argv) > 1 else "output.wav"
    ckpt_dir = argv[2] if len(argv) > 2 else None
    model = (FlowHighSR.from_local(ckpt_dir) if ckpt_dir
             else FlowHighSR.from_pretrained(device=None))
    sr, wav = wavfile.read(in_path)
    wav = wav.astype(np.float32)
    high_res = model.generate(wav, sr, 48000, timestep=1)
    wavfile.write(out_path, 48000,
                  (np.clip(high_res[0], -1, 1) * 32767).astype(np.int16))
    return 0


if __name__ == "__main__":
    sys.exit(main())
