"""Blockwise attention with key-padding segments: kernel F
(``csrc/flash_attn.cu``) and its plain PyTorch version.

``flash_attention`` replaces the JAX package's
``flowhigh_tpu/models/transformer.py:_flash_attention`` (the Pallas TPU
library kernel ``flash_attention`` with segment ids): O(N) memory where the
dense scores of a 5-minute clip (30,000 frames, 16 heads) would take
57.6 GB. It keeps that function's padding semantics: N is padded up to a
multiple of the block ``flash_block(N)`` with q = k = v = 0 in segment 0,
so a masked query (segment 0) attends to the other masked keys AND to the
pad keys (logit 0, value 0); a valid query attends to the valid keys only.

Bound: the two products, 4 N^2 D operations per (batch, head), which the
kernel runs on the tensor cores in 3xTF32 (three TF32 products per f32
product at the TF32 peak; f32 accuracy, with each tensor-core sum joined
to the running ones by f32 adds that round to nearest), plus the
softmax's few operations per score on the FMA units. The kernel: 128
queries a block as 4 warps of 32 rows, 32-key tiles through a two-stage
``cp.async`` ring, Q split once into TF32 hi and lo, the softmax in base
2 (``csrc/flash_attn.cu``; its arithmetic is emulated on the CPU in
``tests/test_torch_flash_plan.py``). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises, and raises under
autograd (no backward, as in the JAX package).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build


def flash_block(n: int) -> int:
    """The JAX function's block size for a sequence of ``n``:
    min(512, max(128, ceil(n / 128) * 128))."""
    return min(512, max(128, -(-n // 128) * 128))


def flash_pad(n: int) -> int:
    """n_pad - n: the pad keys that every masked query also attends to."""
    blk = flash_block(n)
    return -(-n // blk) * blk - n


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor],
                          scale: float) -> torch.Tensor:
    """q, k, v [B, H, N, D]; ``mask`` [B, N] bool (True = valid) or None ->
    [B, H, N, D]. Dense softmax over the keys of the query's segment, with
    the pad keys written out as the JAX function pads them; query rows are
    taken ``flash_block(N)`` at a time, so the scores never exceed
    [B, H, 512, n_pad]."""
    b, _, n, _ = q.shape
    extra = flash_pad(n)
    seg = (torch.ones((b, n), dtype=torch.int32, device=q.device)
           if mask is None else mask.to(torch.int32))
    kp, vp = (F.pad(t, (0, 0, 0, extra)) for t in (k, v))
    seg_k = F.pad(seg, (0, extra))  # pads: segment 0
    out = torch.empty_like(q)
    blk = flash_block(n)
    for i0 in range(0, n, blk):
        sim = torch.matmul(q[:, :, i0:i0 + blk], kp.transpose(-1, -2)) * scale
        same = seg[:, None, i0:i0 + blk, None] == seg_k[:, None, None, :]
        sim = sim.masked_fill(~same, float("-inf"))
        out[:, :, i0:i0 + blk] = torch.matmul(sim.softmax(dim=-1), vp)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor],
                    scale: float) -> torch.Tensor:
    """Blockwise attention (kernel F): q, k, v [B, H, N, D] float32
    contiguous, D in {16, 32, 64}; ``mask`` [B, N] bool or None.

    Forward only, as the JAX function is: it gives the library kernel no
    backward block sizes, so differentiating it raises there
    (``jax/experimental/pallas/ops/tpu/flash_attention.py:254-272``). On a
    CUDA tensor that autograd would differentiate this raises the same
    ``ValueError``; the CPU's plain version stays differentiable, as the
    JAX package's einsum path is off the TPU."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError(
            "flash_attention: Program is being differentiated, but not all "
            "backward blocks are specified (kernel F is forward only, as the "
            "JAX package's flash attention; train with attn_flash=False)")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share one [B, H, N, D] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, n, dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be a contiguous, "
                             f"16-byte aligned float32 tensor on {q.device}")
    if mask is not None and (mask.shape != (b, n) or mask.dtype != torch.bool
                             or mask.device != q.device):
        raise ValueError(f"flash_attention: mask must be [B, N] bool on "
                         f"{q.device}")
    lib = _build.library("flash_attn")
    if not lib.flash_attn_supported(dh):
        raise ValueError(f"flash_attention: no kernel instance for D={dh}")
    if b * h > 65535:
        raise ValueError("flash_attention: B*H must be <= 65535")
    seg = mask.to(torch.int32).contiguous() if mask is not None else None
    out = torch.empty_like(q)
    err = lib.flash_attn_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg.data_ptr() if seg is not None else None, out.data_ptr(),
        b, h, n, dh, flash_pad(n), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attn")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
