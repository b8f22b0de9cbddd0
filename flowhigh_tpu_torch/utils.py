"""Small helpers shared across the port: device resolution, exact-f32
cuDNN convolutions and device copies of host-designed constants; and the
reference's utility surface, counterpart of ``flowhigh_tpu/utils.py``
(masks, 1-D interpolation, pad / trim, log helpers, ``STFTMag``,
``model_summary``, the HTK mel bin)."""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """``None`` means the card: raise when there is none, so that a caller
    who forgot ``device="cpu"`` never runs the plain versions by accident."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "flowhigh_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch path")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


def cudnn_f32():
    """Context for every ``F.conv1d``/``F.conv_transpose1d`` of the port:
    cuDNN stays on, but f32 convolutions run in full f32 instead of the TF32
    cuDNN picks by default on Hopper. Scoped: the previous flags come back on
    exit, so the port sets no global torch flag."""
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark,
                   deterministic=b.deterministic, allow_tf32=False)


_constants: dict = {}
_constants_lock = threading.Lock()


def device_constant(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` (a filter or basis designed once on the host and kept alive
    by its designer's cache) as a tensor on ``device``, copied once. Repeated
    host-to-device copies of pageable memory inside the pipeline would cost
    a copy per clip and may stall the host thread that dispatches it.
    The copy is an ordinary tensor even when the first caller runs under
    ``torch.inference_mode``: an inference tensor could not be saved for
    the backward of a later training step that reads it."""
    device = torch.device(device)
    key = (id(arr), device)
    with _constants_lock:
        hit = _constants.get(key)
        if hit is None or hit[0] is not arr:
            with torch.inference_mode(False):
                hit = (arr, torch.from_numpy(arr).to(device))
            _constants[key] = hit
        return hit[1]


# --- the reference's utility surface (flowhigh_tpu/utils.py) --------------------

def exists(val) -> bool:
    return val is not None


def default(val, d):
    return val if val is not None else d


def divisible_by(num: int, den: int) -> bool:
    return (num % den) == 0


def is_odd(n: int) -> bool:
    return not divisible_by(n, 2)


def sequence_mask(lengths: torch.Tensor,
                  max_length: Optional[int] = None) -> torch.Tensor:
    """[B] lengths -> [B, max_length] bool validity mask (``max_length``
    defaults to the largest length, read back from the device)."""
    lengths = torch.as_tensor(lengths)
    if max_length is None:
        max_length = int(lengths.max())
    x = torch.arange(max_length, dtype=lengths.dtype, device=lengths.device)
    return x[None, :] < lengths[:, None]


def interpolate_1d(t: torch.Tensor, length: int,
                   mode: str = "linear") -> torch.Tensor:
    """Resample the last axis of [B, D, N] (or [B, N]) to ``length``:
    "linear" at half-pixel centres (``align_corners=False``, the edges
    clamped) or "nearest" (source index floor(i N / length))."""
    if mode not in ("linear", "nearest"):
        raise ValueError(f"mode must be 'linear' or 'nearest', got {mode!r}")
    implicit = t.ndim == 2
    if implicit:
        t = t[:, None, :]
    if mode == "nearest":
        n = t.shape[-1]
        idx = torch.clamp(torch.arange(length, device=t.device) * n // length,
                          0, n - 1)
        out = t[..., idx]
    else:
        out = F.interpolate(t, size=length, mode="linear",
                            align_corners=False)
    return out[:, 0, :] if implicit else out


def curtail_or_pad(t: torch.Tensor, target_length: int) -> torch.Tensor:
    """Trim or zero-pad the second-to-last axis to ``target_length``."""
    length = t.shape[-2]
    if length > target_length:
        return t[..., :target_length, :]
    if length < target_length:
        return F.pad(t, (0, 0, 0, target_length - length))
    return t


def mask_from_start_end_indices(seq_len: int, start: torch.Tensor,
                                end: torch.Tensor) -> torch.Tensor:
    """[B, seq_len] bool, True on start <= i < end."""
    start, end = torch.as_tensor(start), torch.as_tensor(end)
    seq = torch.arange(seq_len, device=start.device)
    return (seq[None, :] >= start[:, None]) & (seq[None, :] < end[:, None])


def mask_from_frac_lengths(seq_len: int, frac_lengths: torch.Tensor, *,
                           uniform: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """[B, seq_len] bool span of int(frac * seq_len) frames at a random
    start in [0, seq_len - length]. ``uniform`` [B] is the caller's U[0, 1)
    draw (JAX's draws cannot be made in torch); without it ``generator``
    draws one."""
    frac_lengths = torch.as_tensor(frac_lengths)
    lengths = (frac_lengths * seq_len).to(torch.int32)
    max_start = seq_len - lengths
    if uniform is None:
        uniform = torch.rand(frac_lengths.shape, generator=generator,
                             device=frac_lengths.device)
    start = torch.clamp((max_start * torch.as_tensor(uniform)).to(torch.int32),
                        min=0)
    return mask_from_start_end_indices(seq_len, start, start + lengths)


def safe_log(x: torch.Tensor, clip_val: float = 1e-7) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=clip_val))


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)


def dynamic_range_compression(x, C=1, clip_val=1e-5):
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x, C=1):
    return torch.exp(x) / C


class STFTMag:
    """Magnitude STFT of a waveform [T] or [B, T] -> [B, nfft // 2 + 1,
    frames] (centred, reflect padding)."""

    def __init__(self, nfft: int = 2048, hop: int = 300, window_len: int = 1200):
        self.nfft, self.hop, self.window_len = nfft, hop, window_len

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from .dsp import stft_magnitude
        x = torch.as_tensor(x)
        if x.ndim == 1:
            x = x[None, :]
        return stft_magnitude(x, self.nfft, self.hop, self.window_len,
                              center=True, pad_mode="reflect")


def model_summary(module, name: str = "model") -> str:
    """Parameter counts of a module (its parameters, not its buffers) or a
    state dict, grouped by the first two levels of their names, and the
    total."""
    items = (module.named_parameters() if isinstance(module, torch.nn.Module)
             else module.items())
    groups: dict = {}
    total = 0
    for key, val in items:
        group = ".".join(key.split(".")[:2])
        n = int(np.prod(tuple(val.shape)))
        groups[group] = groups.get(group, 0) + n
        total += n
    width = max((len(g) for g in groups), default=10)
    lines = [f"{name} parameter summary", "=" * (width + 16)]
    for g in sorted(groups):
        lines.append(f"{g:<{width}}  {groups[g]:>12,}")
    lines.append("=" * (width + 16))
    lines.append(f"{'total':<{width}}  {total:>12,}  "
                 f"({total * 4 / 2**20:.1f} MB f32)")
    return "\n".join(lines)


def hz_to_mel_htk(f):
    """HTK mel 2595 log10(1 + f / 700): a float for a number, an array for
    a list or array."""
    if isinstance(f, (list, np.ndarray)):
        f = np.array(f)
    return 2595 * np.log10(1 + f / 700)


def mel_bin_index(frequency, sample_rate, num_mel_bins):
    """The bin of ``frequency`` on ``num_mel_bins`` equal HTK-mel bins over
    [0, sample_rate / 2]: an int, or an int array for an array."""
    m_min = hz_to_mel_htk(0)
    m_max = hz_to_mel_htk(sample_rate / 2)
    bin_index = np.floor((hz_to_mel_htk(frequency) - m_min)
                         / (m_max - m_min) * num_mel_bins)
    if isinstance(bin_index, np.ndarray):
        return bin_index.astype(int)
    return int(bin_index)
