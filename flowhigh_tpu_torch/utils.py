"""Small helpers shared across the port: device resolution and exact-f32
cuDNN convolutions."""

from __future__ import annotations

from typing import Optional

import torch


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
