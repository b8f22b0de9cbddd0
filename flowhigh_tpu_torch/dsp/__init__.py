from .mel import apply_mel, hz_to_mel, log_compress, mel_filterbank, mel_to_hz
from .resample import output_length, resample_poly
from .stft import istft, stft, stft_magnitude

__all__ = [
    "stft", "istft", "stft_magnitude",
    "mel_filterbank", "apply_mel", "log_compress", "hz_to_mel", "mel_to_hz",
    "resample_poly", "output_length",
]
