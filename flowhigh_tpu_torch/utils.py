"""Small helpers shared across the port: device resolution, exact-f32
cuDNN convolutions and device copies of host-designed constants."""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
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


_constants: dict = {}
_constants_lock = threading.Lock()


def device_constant(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` (a filter or basis designed once on the host and kept alive
    by its designer's cache) as a tensor on ``device``, copied once. Repeated
    host-to-device copies of pageable memory inside the pipeline would cost
    a copy per clip and may stall the host thread that dispatches it."""
    device = torch.device(device)
    key = (id(arr), device)
    with _constants_lock:
        hit = _constants.get(key)
        if hit is None or hit[0] is not arr:
            hit = (arr, torch.from_numpy(arr).to(device))
            _constants[key] = hit
        return hit[1]
