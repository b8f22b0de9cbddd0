"""Reduced-precision dots of the vocoder's convolutions (``dot_dtype``):
the port's own copy of the JAX package's rules
(``flowhigh_tpu/ops/packed.py:164-181``, ``_make_conv_kernel`` and the
fused kernels' ``conv`` bodies), and the plain int8 convolution over the
card's windows.

``torch.float32`` (the default) is the exact f32 conv.

The storage dtype of the feature maps (``vocoder_storage_dtype``,
``resolve_storage_dtype``) is another switch, beside the dot dtype: the
JAX package's ``BigVGAN.storage_dtype``. With ``torch.bfloat16`` the
vocoder keeps its MRF maps in bf16 between kernels; kernels A, B, D and E
widen them to f32 on load (exact), compute as on f32 maps, and round the
one map they store (nearest even). Every dot dtype below applies
unchanged on the widened values.

``torch.bfloat16``: both operands of every product are rounded to bf16
(round to nearest even) and the products summed in f32. A bf16 x bf16
product is exact in f32, so this is ``round_bf16`` of both operands, then
the f32 conv. Feature maps stay f32 in device memory.

``torch.int8``:

- weights, once per weight tensor: per output channel o,
  ``s_w[o] = max(amax_w[o], 1e-30) / 127`` with the amax over (Cin, K),
  and ``wq = clip(round(w / s_w), -127, 127)`` (a division, not a product
  with the reciprocal). The JAX package scales per lane of the packed
  [Q, p Cin, p Cout] weight block; every packed lane of output channel o
  holds all K Cin taps of o plus zeros, so the two scales are the same;
- activations, one scalar per window: ``amax = max(max |a|, 1e-30)``,
  ``aq = round(a * (127 / amax))`` with ``127 / amax`` formed first, and
  ``s_x = amax / 127``;
- ``y = float(sum aq wq) * (s_x * s_w[o])`` with the sum exact (int32 on
  the card), the factor formed before the product; then bias, residuals
  and ``out_scale`` as in f32.

The vocoder's compute dtype (``BigVGAN(dtype=)``, ``MelVoco(dtype=)``,
``resolve_compute_dtype``) is a third switch: the JAX package's
``BigVGAN.dtype``. With ``torch.bfloat16`` every conv's weights are
rounded to bf16 values before the kernel (``compute_weights``; the JAX
package's ``w.astype(dtype)``), and the maps the JAX package's fused
vocoder then keeps in bf16 are bf16 tensors (``models/bigvgan.py``); the
dot dtype applies on top, to those rounded weights and the maps' values.

Rounding is half to even everywhere (``torch.round``; ``rintf`` /
``__float2int_rn`` in the kernels). Every quotient is an IEEE division of
two tensors: PyTorch takes ``number / tensor`` as a product with the
reciprocal, and on CUDA ``tensor / number`` too, which can differ by one
ulp from the kernels' ``127.0f / amax`` and ``amax / 127.0f``.

The window, and why int8 matches the JAX package only where one window
covers the sequence: the TPU kernel takes one activation scale per TPU
tile; the port takes one per tile of the card's kernels, per batch row,
over all input channels. This is the partition, which every plain version
takes as its ``tile`` argument so that the card can hold a kernel against
it:

- a conv (kernel B) or an act->conv pair (kernel D) owning outputs
  [t0, t0 + tile), t0 = 0, tile, 2 tile, ... (tile = 256, the kernels'
  time tile): the activation over [t0 - pad, t0 + tile + pad) ∩ [0, T),
  pad = d (K - 1) / 2;
- an AMPBlock1 unit (kernel E) owning outputs [t0, t0 + tile), tile =
  256 - 2 H, H = ``unit_halo(K)``: conv1 runs over [t0 - H, t0 + tile + H)
  on act1 over [t0 - H - pad1, t0 + tile + H + pad1) ∩ [0, T) (one scale),
  and conv2 on act2 over [t0 - pad2, t0 + tile + pad2) ∩ [0, T) (another).

Where the whole sequence fits one tile on both machines, both take one
window, the whole sequence, and agree to f32 rounding; at longer T they
quantise over different windows and agree to quantisation grade only.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

DOT_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def check_dot_dtype(dot_dtype: torch.dtype) -> torch.dtype:
    if dot_dtype not in DOT_DTYPES:
        raise ValueError(f"dot_dtype must be one of {DOT_DTYPES}, got "
                         f"{dot_dtype!r}")
    return dot_dtype


CONV_DTYPES = {None: None, torch.bfloat16: torch.bfloat16,
                torch.int8: torch.int8, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


def resolve_conv_dtype(value) -> Optional[torch.dtype]:
    """``vocoder_conv_dtype`` -> None (float32), torch.bfloat16 or
    torch.int8."""
    try:
        return CONV_DTYPES[value]
    except (KeyError, TypeError):
        raise ValueError("vocoder_conv_dtype must be None, torch.bfloat16, "
                         f"torch.int8, 'bfloat16' or 'int8', got {value!r}"
                         ) from None


# vocoder_storage_dtype: None (float32 maps) or torch.bfloat16, also by
# name ("bfloat16", "float32"), which is how the JAX package's
# jnp.bfloat16 / jnp.float32 arrive (the port imports no JAX)
STORAGE_DTYPES = {None: None, torch.float32: None, torch.bfloat16:
                  torch.bfloat16, "float32": None, "bfloat16": torch.bfloat16}


def resolve_storage_dtype(value, name: str = "vocoder_storage_dtype"
                          ) -> Optional[torch.dtype]:
    """``vocoder_storage_dtype`` -> None (float32 feature maps) or
    torch.bfloat16. Takes None, torch.float32, torch.bfloat16, their names
    and any object named so (the JAX package's ``jnp.bfloat16``); ``name``
    is the caller's keyword for the message."""
    key = value
    if not isinstance(value, (str, torch.dtype)) and value is not None:
        key = getattr(value, "__name__", value)
    try:
        return STORAGE_DTYPES[key]
    except (KeyError, TypeError):
        raise ValueError(f"{name} must be None, torch.float32, "
                         f"torch.bfloat16, 'float32' or 'bfloat16', got "
                         f"{value!r}") from None


def resolve_compute_dtype(value) -> torch.dtype:
    """The vocoder's compute dtype (``dtype``) -> torch.float32 or
    torch.bfloat16; it takes what ``resolve_storage_dtype`` takes (None is
    float32) and refuses anything else with ``ValueError``."""
    return resolve_storage_dtype(value, "dtype") or torch.float32


def check_lowering_switches(fused, packed, kernel_pipeline,
                            names=("fused_vocoder", "packed_vocoder",
                                   "vocoder_kernel_pipeline")) -> None:
    """Validate the JAX package's TPU lowering switches (a bool, None or a
    bool, an int >= 1), which the card's kernels do not depend on;
    ``names`` are the caller's keywords for the messages."""
    if not isinstance(fused, bool):
        raise ValueError(f"{names[0]} must be a bool, got {fused!r}")
    if packed is not None and not isinstance(packed, bool):
        raise ValueError(f"{names[1]} must be None or a bool, got {packed!r}")
    if isinstance(kernel_pipeline, bool) or not isinstance(
            kernel_pipeline, int) or kernel_pipeline < 1:
        raise ValueError(f"{names[2]} must be an int >= 1, got "
                         f"{kernel_pipeline!r}")


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (ties to even), as f32."""
    return t.bfloat16().float()


def quantize_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[Cout, ...] f32 -> (int32 weights in [-127, 127], [Cout] f32 scales),
    the JAX package's ``_quant_weights_per_cout``."""
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    s_w = torch.clamp(amax, min=1e-30) / torch.full_like(amax, 127.0)
    wq = torch.clamp(torch.round(w / s_w.reshape((-1,) + (1,) * (w.dim() - 1))),
                     -127, 127)
    return wq.to(torch.int32), s_w


def _version(t: torch.Tensor):
    try:
        return t._version
    except RuntimeError:  # an inference tensor keeps no version counter
        return None


def _cached(w: torch.Tensor, tag: str, make: Callable):
    """``make(w)`` cached on the tensor itself, keyed by its version counter
    (bumped by every in-place write: ``load_state_dict``, ``seeded_init_``,
    ``copy_``), its storage, device and shape. A tensor without a version
    counter (made under ``torch.inference_mode``) is prepared anew on every
    call."""
    version = _version(w)
    key = (version, w.data_ptr(), w.device, tuple(w.shape))
    hit = getattr(w, "_fht_dot_cache", {}).get(tag)
    if version is not None and hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        val = make(w.detach())
    if version is not None:
        if not hasattr(w, "_fht_dot_cache"):
            w._fht_dot_cache = {}
        w._fht_dot_cache[tag] = (key, val)
    return val


def bf16_weights(w: torch.Tensor) -> torch.Tensor:
    """``round_bf16(w)``, once per weight tensor."""
    return _cached(w, "bf16", round_bf16)


def compute_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The weights a vocoder conv hands its kernel at the compute dtype
    ``dtype``: ``w`` itself at float32; at bfloat16 its values rounded to
    bf16 as a float32 tensor (the JAX package's ``w.astype(dtype)`` ahead of
    each kernel), once per weight tensor under a tag of their own. The
    kernels' layout caches (``conv_weights``, ``convt_weights``,
    ``int8_weights``, D's and E's) then key on the rounded tensor, so a
    weight tensor never returns the layout of its rounded values, nor the
    other way round. The rounded tensor is made outside inference mode: it
    keeps a version counter, so the caches on it hold across calls made
    under ``torch.inference_mode`` (``MelVoco.decode``)."""
    if dtype != torch.bfloat16:
        return w

    def make(v):
        with torch.inference_mode(False):
            return round_bf16(v)
    return _cached(w, "compute_bf16", make)


def int8_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_weights(w)``, once per weight tensor."""
    return _cached(w, "int8", quantize_weights)


def windows(a: torch.Tensor, lo: int, width: int, tile: int,
            n: int) -> torch.Tensor:
    """[B, C, T] -> [B, n, C, width]: window i covers positions
    [i tile + lo, i tile + lo + width), zero outside [0, T)."""
    t = a.shape[-1]
    left, right = max(0, -lo), max(0, (n - 1) * tile + lo + width - t)
    ap = F.pad(a, (left, right))[..., max(0, lo):]
    return ap.unfold(2, width, tile)[:, :, :n].permute(0, 2, 1, 3)


def window_amax(a: torch.Tensor, lo: int, width: int, tile: int, n: int,
                group: int = 8) -> torch.Tensor:
    """[B, C, T] -> [B, n, ceil(C / group)]: the largest |a| of each window
    (``windows``) and each ``group`` channels, zero where a window or a
    group holds no value: the partial maxima the int8 kernels' pre-passes
    write, whose largest is the window's amax."""
    bsz, c, _ = a.shape
    win = windows(a, lo, width, tile, n).abs()              # [B, n, C, W]
    groups = -(-c // group)
    win = F.pad(win, (0, 0, 0, groups * group - c))
    return win.reshape(bsz, n, groups, group * width).amax(dim=-1)


def int8_conv_windows(win: torch.Tensor, w: torch.Tensor,
                      dilation: int) -> torch.Tensor:
    """int8 conv of each window of ``win`` [B, n, Cin, W] (one activation
    scale per window) with w [Cout, Cin, K], valid positions only ->
    [B, n, Cout, W - d (K - 1)] f32, dequantised, no bias.

    The integer sums run in float64: every partial sum is an integer below
    K Cin 127^2 < 2^53, so they are exact in any order, as int32 sums are
    on the card."""
    bsz, n, cin, width = win.shape
    wq, s_w = int8_weights(w)
    amax = torch.clamp(win.abs().amax(dim=(2, 3)), min=1e-30)     # [B, n]
    c127 = torch.full_like(amax, 127.0)
    aq = torch.round(win * (c127 / amax)[..., None, None])
    s_x = amax / c127
    acc = F.conv1d(aq.reshape(bsz * n, cin, width).double(), wq.double(),
                   dilation=dilation)
    acc = acc.float().reshape(bsz, n, wq.shape[0], -1)
    return acc * (s_x[..., None] * s_w[None, None, :])[..., None]


def untile(y: torch.Tensor, t: int) -> torch.Tensor:
    """[B, n, C, tile] -> [B, C, T]: the tiles side by side, cut to T."""
    bsz, n, c, tile = y.shape
    return y.permute(0, 2, 1, 3).reshape(bsz, c, n * tile)[..., :t]


def conv1d_int8(a: torch.Tensor, w: torch.Tensor, *, dilation: int,
                tile: int) -> torch.Tensor:
    """The int8 "same" conv of ``a`` [B, Cin, T] (zero padding) over the
    partition of kernels B and D: one scale per window [t0 - pad, t0 + tile
    + pad) ∩ [0, T) -> [B, Cout, T] f32, dequantised, no bias."""
    t, pad = a.shape[-1], dilation * (w.shape[-1] - 1) // 2
    n = -(-t // tile)
    win = windows(a, -pad, tile + 2 * pad, tile, n)
    return untile(int8_conv_windows(win, w, dilation), t)
