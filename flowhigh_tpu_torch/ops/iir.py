"""One pass of a second-order-section IIR cascade over the rows of a
[R, T] float32 tensor: the sosfilt kernel (``csrc/sosfilt.cu``) and its
plain PyTorch version. ``dsp.filters.sosfiltfilt`` pads and crops around
two passes, forward and reverse.

No Pallas kernel is replaced: this is the counterpart of the JAX package's
``lax.scan`` (``flowhigh_tpu/dsp/filters.py:_sosfilt``), which XLA
compiles into one loop while eager PyTorch launches several operations a
section a sample. Both versions compute the scan's float32 arithmetic in
its order, every product and sum rounded on its own, so the kernel gives
the plain version's bits. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

COEFS = 7  # a section's row: b0 b1 b2 a1 a2 zi0 zi1 (a0 == 1)


def cascade(sos: np.ndarray, zi: np.ndarray) -> np.ndarray:
    """The kernel's coefficients, [S, 7] float32: a normalised [S, 6]
    cascade's b0 b1 b2 a1 a2 beside its ``sosfilt_zi`` state [S, 2], each
    rounded to float32 as the JAX function rounds them."""
    sos = np.asarray(sos, np.float64)
    return np.ascontiguousarray(np.concatenate(
        [sos[:, [0, 1, 2, 4, 5]].astype(np.float32),
         np.asarray(zi, np.float64).astype(np.float32)], axis=1))


def sosfilt_plain(coefs: np.ndarray, x: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """The pass as a loop over time in PyTorch: ``coefs`` [S, 7] from
    ``cascade``, ``x`` [R, T] float32; the initial state is the ``zi``
    columns times the pass's first sample (``x[:, -1]`` when ``reverse``)."""
    c = torch.from_numpy(np.asarray(coefs, np.float32)).to(x.device)
    sections = [row.unbind() for row in c]  # 0-d float32 tensors
    x0 = x[:, -1] if reverse else x[:, 0]
    z1 = [sec[5] * x0 for sec in sections]
    z2 = [sec[6] * x0 for sec in sections]
    out = torch.empty_like(x)
    t_len = x.shape[1]
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        v = x[:, t]
        for s, (b0, b1, b2, a1, a2, _, _) in enumerate(sections):
            y = b0 * v + z1[s]
            z1[s] = b1 * v + z2[s] - a1 * y
            z2[s] = b2 * v - a2 * y
            v = y
        out[:, t] = v
    return out


def sosfilt(coefs: np.ndarray, x: torch.Tensor,
            reverse: bool = False) -> torch.Tensor:
    """The pass (the sosfilt kernel on the card): ``coefs`` [S, 7] float32
    on the host (S <= the kernel's ``sosfilt_max_sections``), ``x`` [R, T]
    float32 contiguous. Returns a new [R, T] tensor."""
    if x.device.type == "cpu":
        return sosfilt_plain(coefs, x, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"sosfilt: unsupported device {x.device}")
    coefs = np.ascontiguousarray(coefs, np.float32)
    if coefs.ndim != 2 or coefs.shape[1] != COEFS:
        raise ValueError(f"sosfilt: coefs must be [S, {COEFS}], got "
                         f"{coefs.shape}")
    if x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("sosfilt: x must be a contiguous [R, T] float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    lib = _build.library("sosfilt")
    if not 1 <= coefs.shape[0] <= lib.sosfilt_max_sections():
        raise ValueError(f"sosfilt: no kernel instance for "
                         f"{coefs.shape[0]} sections")
    rows, t_len = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    err = lib.sosfilt_f32(
        coefs.ctypes.data_as(ctypes.c_void_p), coefs.shape[0], x.data_ptr(),
        y.data_ptr(), rows, t_len, int(reverse),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "sosfilt")
    sosfilt.launches += 1
    return y


sosfilt.launches = 0
