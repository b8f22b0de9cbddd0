"""Training data — counterpart of ``flowhigh_tpu/train/data.py``. Only
``load_wav_mono`` is ported (the CLI reads its wavs with it); the degrading
datasets and batch iterators are ROADMAP.md queue 1 item 12. WAV IO uses
scipy."""

from __future__ import annotations

import numpy as np
import scipy.io.wavfile as wavfile


def load_wav_mono(path, keep_int16: bool = False) -> tuple[np.ndarray, int]:
    """Read a wav as mono float32 in [-1, 1] (int16 / 32768, int32 /
    2^31, uint8 centred at 128; stereo averaged). With ``keep_int16=True``
    a mono 16-bit file comes back as raw int16: ``FlowHighSR.generate`` and
    ``ServingPipeline.submit`` upload it as int16 and divide by 32768 on the
    device, bit-identical to the float path. Stereo int16 still converts
    (the channel mean is not int16)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        if keep_int16 and data.ndim == 1:
            return data, sr
        wave = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wave = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wave = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wave = data.astype(np.float32)
    if wave.ndim == 2:
        wave = wave.mean(axis=1)
    return wave, sr
