from .mel import (apply_mel, hz_to_mel, hz_to_mel_htk_np, log_compress,
                  mel_filterbank, mel_filterbank_htk, mel_to_hz,
                  mel_to_hz_htk_np)
from .resample import output_length, resample_poly, upsample_to_48k
from .stft import (frame_signal, hann_window, istft, num_frames, stft,
                   stft_magnitude)
from .filters import cheby1_sos, host_degrade, sosfiltfilt

__all__ = [
    "stft", "istft", "stft_magnitude", "hann_window", "frame_signal",
    "num_frames",
    "mel_filterbank", "apply_mel", "log_compress", "hz_to_mel", "mel_to_hz",
    "mel_filterbank_htk", "hz_to_mel_htk_np", "mel_to_hz_htk_np",
    "resample_poly", "output_length", "upsample_to_48k",
    "cheby1_sos", "host_degrade", "sosfiltfilt",
]
