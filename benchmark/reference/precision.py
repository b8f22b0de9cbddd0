"""The products of the plain reference, and the lower precisions of its
controls.

Every matrix product of ``field.py`` goes through ``linear``; with ``quant``
None it is one float32 ``matmul``. The controls stand in for the program at
the precision just below the one a configuration states:

- ``tf32()``: float32 with TF32 on, for cuBLAS and cuDNN (the configurations
  state float32 with TF32 off);
- ``FP8``: for a configuration that computes in bfloat16, each product's
  inputs rounded to float8 e4m3 with a per-tensor scale (its largest value
  at 448), and under autograd the incoming gradient rounded to e5m2 the
  same way: the recipe of fp8 training. The products themselves sum in
  float32.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def linear(x: torch.Tensor, w: torch.Tensor, b, quant=None) -> torch.Tensor:
    """x @ w^T (+ b), over the last two dimensions."""
    if quant is not None:
        return quant(x, w, b)
    y = torch.matmul(x, w.transpose(-1, -2))
    return y if b is None else y + b


def round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn,
              top: float = E4M3_MAX) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale, back in x's
    dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = round_fp8(x), round_fp8(w)
        ctx.save_for_backward(xq, wq)
        return torch.matmul(xq, wq.transpose(-1, -2))

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = round_fp8(g, torch.float8_e5m2, E5M2_MAX)
        gx = torch.matmul(gq, wq)
        gw = torch.matmul(gq.transpose(-1, -2), xq)
        # sum over the batch dimensions a broadcast weight did not have
        while gw.ndim > wq.ndim:
            gw = gw.sum(0)
        return gx, gw


def fp8(x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """``linear`` with fp8 inputs (the ``quant`` of the bfloat16 control)."""
    y = _Fp8Matmul.apply(x, w)
    return y if b is None else y + b


@contextlib.contextmanager
def tf32():
    """cuBLAS and cuDNN take TF32 for float32 products inside."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@contextlib.contextmanager
def full_f32():
    """cuBLAS and cuDNN in full float32 inside (the reference's own)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
