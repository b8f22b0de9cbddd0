"""The probe kernels: G (``csrc/probe_snake.cu``), H (``csrc/probe_fir.cu``),
kernel A's firs-only instance (``csrc/snake_aa.cu``), and their plain
PyTorch versions.

They are the card's counterparts of the round-4 microbenchmark probes of
``scripts/bench_act_mxu.py`` and ask its two questions on the card:

- ``snake_only`` (G) replaces the Pallas kernel ``snake_only`` (its
  ``pallas_call`` at ``scripts/bench_act_mxu.py:52``): the snake alone on
  2x the elements, kernel A's arithmetic floor. Bound: device memory, 8
  bytes per element.
- ``mxu_fir`` (H) replaces ``mxu_fir`` (``pallas_call`` at ``:102``): the
  up-FIR as a matrix product [S, L] @ [L, 2L] over three row shifts, the
  snake, the down-FIR as [S, 2L] @ [2L, L] over three shifts, in one
  kernel. Bound: operations, 24 S L^2, on the tensor cores: in 3xTF32
  for float32 weights (``mma.sync``), at the bf16 rate for bfloat16
  weights (``wgmma``, clusters of two blocks).
- ``act_firs_only`` is kernel A with the snake replaced by the identity,
  ``down2(up2(x))``: the JAX script's ``firs_only`` row, which
  monkeypatches ``ops/packed.py:_snake_packed``.

G and H keep the JAX layout, [B, S, L] with the lanes last (L = p * C in
the script; the port has no packing, so p only sets the width);
``act_firs_only`` takes kernel A's [B, C, T]. No model path calls them:
``scripts/port_bench_act_mxu.py`` and ``chip_smoke.py`` do. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .conv import _stream
from .fused_act import taps_host
from .quant import round_bf16

HALO = 8  # the JAX kernel's neighbour blocks: 8 rows


def _check_device(what: str, x: torch.Tensor, *tensors) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    for v in tensors:
        if v.device != x.device:
            raise ValueError(f"{what}: every input must be on {x.device}")


def _check_card(what: str, *tensors) -> None:
    for v in tensors:
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and 16-byte "
                             "aligned")


def snake_probe(u: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The JAX package's packed snake (``ops/packed.py:_snake_packed``):
    u + h - h cos(2 a u), h = 0.5 / (b + 1e-9), a and b already exp'd,
    broadcast over the last axis."""
    h = 0.5 / (b + 1e-9)
    return u + h - h * torch.cos(u * (2.0 * a))


# --- G -----------------------------------------------------------------------

def _check_snake_only(x: torch.Tensor, ab: torch.Tensor) -> None:
    _check_device("snake_only", x, ab)
    if x.dim() != 3 or ab.shape != (2, x.shape[-1]):
        raise ValueError(f"snake_only: x must be [B, S, L] and ab [2, L], got "
                         f"{tuple(x.shape)} and {tuple(ab.shape)}")
    if x.dtype != torch.float32 or ab.dtype != torch.float32:
        raise ValueError("snake_only: x and ab must be float32")


def snake_only_plain(x: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """[B, S, L] -> snake(x) + snake(x + 1), per-lane a, b = ab."""
    _check_snake_only(x, ab)
    return snake_probe(x, ab[0], ab[1]) + snake_probe(x + 1.0, ab[0], ab[1])


def snake_only(x: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """[B, S, L] float32, ab [2, L] -> [B, S, L] (kernel G on a CUDA
    tensor)."""
    _check_snake_only(x, ab)
    if x.device.type == "cpu":
        return snake_only_plain(x, ab)
    _check_card("snake_only", x, ab)
    out = torch.empty_like(x)
    err = _build.library("probe_snake").snake_only_f32(
        x.data_ptr(), ab.data_ptr(), out.data_ptr(), x.shape[0] * x.shape[1],
        x.shape[2], _stream(x))
    _build.check(err, "snake_only")
    snake_only.launches += 1
    return out


snake_only.launches = 0


# --- kernel A, firs only ---------------------------------------------------------

def act_firs_only_plain(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T] -> downsample1d(upsample1d(x)): kernel A's FIRs and edges
    without the snake."""
    from ..models.bigvgan import downsample1d, upsample1d
    return downsample1d(upsample1d(x, 2, 12), 2, 12)


def act_firs_only(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T] float32 -> [B, C, T] (kernel A's firs-only instance on a
    CUDA tensor)."""
    _check_device("act_firs_only", x)
    if x.dim() != 3 or x.dtype != torch.float32:
        raise ValueError("act_firs_only: x must be a float32 [B, C, T] tensor")
    if x.device.type == "cpu":
        return act_firs_only_plain(x)
    if not x.is_contiguous():
        raise ValueError("act_firs_only: x must be contiguous")
    bsz, c, t = x.shape
    y = torch.empty_like(x)
    err = _build.library("snake_aa").snake_aa_firs_f32(
        x.data_ptr(), taps_host(), y.data_ptr(), bsz * c, t, _stream(x))
    _build.check(err, "snake_aa_firs")
    act_firs_only.launches += 1
    return y


act_firs_only.launches = 0


# --- H -----------------------------------------------------------------------

MXU_FIR_MAX_L = 384  # the card's accumulator registers (csrc/probe_fir.cu)


def mxu_fir_instance(dtype: torch.dtype, do_snake: bool) -> str:
    """The C entry point of H for weights of ``dtype``: mxu_fir_f32,
    mxu_fir_f32_dots, mxu_fir_bf16, mxu_fir_bf16_dots."""
    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    return f"mxu_fir_{name}" + ("" if do_snake else "_dots")


def _check_mxu_fir(x, up, dn, ab2) -> None:
    _check_device("mxu_fir", x, up, dn, ab2)
    if x.dim() != 3:
        raise ValueError(f"mxu_fir: x must be [B, S, L], got {tuple(x.shape)}")
    _, s, lanes = x.shape
    if (up.shape != (3, lanes, 2 * lanes) or dn.shape != (3, 2 * lanes, lanes)
            or ab2.shape != (2, 2 * lanes)):
        raise ValueError(f"mxu_fir: up [3, L, 2L], dn [3, 2L, L] and ab2 "
                         f"[2, 2L] with L = {lanes}, got {tuple(up.shape)}, "
                         f"{tuple(dn.shape)}, {tuple(ab2.shape)}")
    if x.dtype != torch.float32 or ab2.dtype != torch.float32:
        raise ValueError("mxu_fir: x and ab2 must be float32")
    if up.dtype not in (torch.float32, torch.bfloat16) or dn.dtype != up.dtype:
        raise ValueError(f"mxu_fir: up and dn must both be float32 or both "
                         f"bfloat16, got {up.dtype} and {dn.dtype}")
    if s < HALO or s % HALO:
        raise ValueError(f"mxu_fir: S must be a multiple of {HALO} (the JAX "
                         f"kernel's row blocks), got {s}")


def mxu_fir_plain(x: torch.Tensor, up: torch.Tensor, dn: torch.Tensor,
                  ab2: torch.Tensor, *, do_snake: bool = True) -> torch.Tensor:
    """[B, S, L] -> [B, S, L], written from the definition: xe is x with
    the clamped 8-row neighbour blocks (xe[r] = x[r + 8] for r < 0,
    x[r - 8] for r >= S), s2[r] = sum_q xe[r + q] @ up[q + 1] for r in
    [-1, S + 1), the snake (``snake_probe``, a, b = ab2) when ``do_snake``,
    out[r] = sum_q s2[r + q] @ dn[q + 1]. With bfloat16 weights xe and s2
    are rounded to bf16 before their products and the sums are float32."""
    _check_mxu_fir(x, up, dn, ab2)
    s = x.shape[1]
    rnd = round_bf16 if up.dtype == torch.bfloat16 else (lambda v: v)

    xe = rnd(torch.cat([x[:, HALO - 2:HALO], x, x[:, s - HALO:s - HALO + 2]],
                       dim=1))                  # rows -2 .. S + 1
    upf, dnf = up.float(), dn.float()
    s2 = sum(torch.matmul(xe[:, q:q + s + 2], upf[q]) for q in range(3))
    if do_snake:
        s2 = snake_probe(s2, ab2[0], ab2[1])
    s2 = rnd(s2)                                # rows -1 .. S
    return sum(torch.matmul(s2[:, q:q + s], dnf[q]) for q in range(3))


def mxu_fir(x: torch.Tensor, up: torch.Tensor, dn: torch.Tensor,
            ab2: torch.Tensor, *, do_snake: bool = True) -> torch.Tensor:
    """[B, S, L] float32 -> [B, S, L] float32; ``up``/``dn`` float32 or
    bfloat16 choose the instance. Kernel H on a CUDA tensor: L % 64 == 0 and
    L <= 384 there."""
    _check_mxu_fir(x, up, dn, ab2)
    if x.device.type == "cpu":
        return mxu_fir_plain(x, up, dn, ab2, do_snake=do_snake)
    bsz, s, lanes = x.shape
    if lanes % 64 or lanes > MXU_FIR_MAX_L or bsz > 65535:
        raise ValueError(f"mxu_fir: the kernel takes L % 64 == 0, L <= "
                         f"{MXU_FIR_MAX_L} and B <= 65535, got L = {lanes}, "
                         f"B = {bsz}")
    _check_card("mxu_fir", x, up, dn, ab2)
    out = torch.empty_like(x)
    lib = _build.library("probe_fir")
    # a prep kernel lays up and dn out here, at each call, as the slices
    # the kernel reads
    scratch = torch.empty(
        lib.mxu_fir_scratch_bytes(lanes, int(up.dtype == torch.bfloat16)),
        dtype=torch.uint8, device=x.device)
    inst = mxu_fir_instance(up.dtype, do_snake)
    err = getattr(lib, inst)(
        x.data_ptr(), up.data_ptr(), dn.data_ptr(), ab2.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), bsz, s, lanes, _stream(x))
    _build.check(err, inst)
    mxu_fir.launches += 1
    mxu_fir.instance_launches[inst] += 1
    return out


mxu_fir.launches = 0
mxu_fir.instance_launches = {mxu_fir_instance(d, s): 0
                             for d in (torch.float32, torch.bfloat16)
                             for s in (True, False)}
