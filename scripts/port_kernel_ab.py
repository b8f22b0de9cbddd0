#!/usr/bin/env python3
"""Time the port's fused vocoder kernels on one CUDA card, for A/B runs.

    python3 scripts/port_kernel_ab.py [TREE] [--fused | --conv | --act |
                                      --flash | --fir | --field] [--int8]

Imports ``flowhigh_tpu_torch`` (and the tree's ``chip_smoke.py``) from
TREE (default: this checkout), so two versions of a kernel compare in one
call on one card: copy the other version's tree into a directory that
.gitignore lists (``build/...``) and run the script for each tree in turn,
A B B A. Prints one JSON line of mean ms (15 launches after 3 warm-up
launches, CUDA events; a shape timed once and weighted by its launches):

- kernel D (``act_conv1d``) and kernel E (``amp_unit``), float32,
  bfloat16 and int8 instances, at every shape of the fused path of a 10 s
  clip at that dtype (``chip_smoke.main_path_calls``: 36 pairs at C = 768
  and 384, 27 units at C = 192, 96 and 48), with the unfused chain of
  kernels A and B that does the same work at the same dtype (for int8:
  A + B.int8): per (C, K, d) (``D 768 3 1``, ``D chain 768 3 1``), per
  stage (``D 768 sum``) and per clip (``D sum``, ``D chain sum``; ``E
  ...``, ``D.bf16 ...`` and ``D.int8 ...`` alike);
- kernel C (``conv_transpose1d``), float32 and bfloat16 instances, at the
  five upsampler shapes of a 10 s clip (Cin, Cout, T_in, u, K), with their
  per-clip sums (``C sum``, ``C.bf16 sum``);
- kernel B (``conv1d``), float32, bfloat16 and int8 instances, at every
  conv of the unfused path of a 10 s clip at that dtype (91 launches: the
  resblock convs of each stage, Cin = Cout = C, T, K, d, residuals; and
  conv_post, which stays float32 under int8, so B.int8 has 90): per (C, K,
  d) (``B 768 3 1``), per stage (``B 768 sum``), conv_post (``B post``)
  and per clip (``B sum``), the same for ``B.bf16`` and ``B.int8``.

- kernel A (``snake_activation1d``) at every shape of the unfused path
  of a 10 s clip (91 launches: 18 a stage and ``activation_post``) and
  the default path's one launch, through its wrapper (``A``) and as
  device time alone (``A graph``: the 15 launches captured in a CUDA
  graph and replayed, so the wrapper's host cost is left out) and the
  host time of its call (``A host``: the enqueue alone); beside
  it, at the same shapes and launches, A's firs-only instance
  (``A.firs``, the snake as the identity), probe G (``G``, the snake
  alone on the same elements as [1, C * T / 384, 384], the probe script's
  width) and the bytes bound
  (``A bound``): per stage (``A 768 sum``), per clip (``A sum``) and
  for the default path (``A default``). One call of this mode on a
  parent tree and on copies that drop one part of A each gives the
  elimination split.

- kernel F (``flash_attention``) at the model's 16 heads of 64 and its
  qk-norm scale 10, with a frame mask as the vector field passes it: the
  300 s long-form clip (N = 30,000, all valid; ``F 30000`` a launch,
  ``F clip`` its two launches a clip) and StreamingSR's 10 s chunks (N =
  1,000: ``F 1000 b1``, ``F 1000 b2``, and ``F 1000 b2 masked`` with 950
  and 998 valid frames), through its wrapper (``F ...``) and as device
  time alone (``F graph ...``, CUDA graph); at N = 1,000 also, under
  ``max_abs``, F's largest difference from its plain version in float32
  and in float64, and the float32 plain version's from the float64 one.
  One call of this mode on a parent tree and on the copies of
  ``scripts/port_flash_elim.py`` gives F's elimination split.

- probe kernel H (``mxu_fir``), its four instances (``H f32``, ``H
  f32_dots``, ``H bf16``, ``H bf16_dots``) at the three probe cases with p
  > 1 of ``scripts/port_bench_act_mxu.py`` (S = 60,000, 60,000, 40,000
  rows of L = 384; the script's inputs, drawn from its seed in its
  order): through the wrapper (``H f32 s5``) and as device time alone
  (``H graph f32 s5``, CUDA graph), summed over the cases (``H f32 sum``,
  ``H graph f32 sum``), the plain version's time (``H plain f32 sum``), and
  the bounds: 24 S L^2 operations at the bf16 tensor-core peak, and for
  the f32 instances in 3xTF32 terms (three TF32 products at the TF32
  peak, ``H bound f32 sum``) and at the f32 FMA peak (``H bound f32 fma
  sum``); under ``max_abs`` each instance's error against its plain
  version as chip_smoke.py phase M measures it. One call of this mode on
  a parent tree and on the copies of ``scripts/port_fir_elim.py`` gives
  H's elimination split.

- the vector field (``--field``, no kernel of this package: cuBLAS and
  cuDNN) at full width with seeded weights on a 10 s clip's mel (1,000
  frames, all valid): first ``sample dopri5 host``:
  ``FlowHighSR.sample(decode_to_audio=False)`` with
  ``ode_method="adaptive"`` on the clip at 48 kHz, the mel solve of
  chip_smoke.py phase S1 without the vocoder (host ms with the read-back,
  median of 5 after one warm-up run); then each configuration of
  ``FIELDS`` that the tree ports (an older tree computes in float32 only
  and lacks the options): CUDA events around one call (``field f32``,
  median of 30 after 5 warm-up calls) and the host wall of 7 calls and a
  synchronize (``field f32 loop7 host``, median of 10: one step of the
  adaptive solver).

``--fused`` times D and E alone, ``--conv`` B alone, ``--act`` A alone
(with its firs-only instance and G), ``--flash`` F alone, ``--fir`` H
alone, ``--field`` the vector field alone; ``--int8`` keeps
the int8 instances alone (D.int8 and E.int8 with their A + B.int8 chains,
and B.int8): ``--fused --int8`` D.int8 and E.int8, ``--conv --int8``
B.int8. Inputs are seeded random tensors. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

# BigVGAN's upsamplers on a 10 s clip (1,000 frames): Cin, Cout, T_in, u, K
UPSAMPLERS = [(1536, 768, 1000, 5, 11), (768, 384, 5000, 4, 8),
              (384, 192, 20000, 4, 8), (192, 96, 80000, 3, 7),
              (96, 48, 240000, 2, 4)]
# the resblocks' stages on a 10 s clip (C, T), and BigVGAN's (K, dilations)
STAGES = [(768, 5000), (384, 20000), (192, 80000), (96, 240000),
          (48, 480000)]
RESBLOCKS = [(3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5))]


def unfused_convs() -> dict:
    """Kernel B's launches on the unfused path of a 10 s clip:
    {(C, T, K, d, residuals, out_scale): launches}; conv_post is (48, T,
    7, 1, 0, 1.0) with one output channel. Per AMPBlock1 unit: conv1 (K, d)
    and conv2 (K, 1) with the unit's input as residual; the last unit of a
    stage also takes the other two blocks' outputs and the 1/3 average."""
    out: dict = {}
    for c, t in STAGES:
        for j, (k, dils) in enumerate(RESBLOCKS):
            for m, d in enumerate(dils):
                last = j == len(RESBLOCKS) - 1 and m == len(dils) - 1
                for key in ((c, t, k, d, 0, 1.0),
                            (c, t, k, 1, 3 if last else 1,
                             1.0 / 3 if last else 1.0)):
                    out[key] = out.get(key, 0) + 1
    return out


def time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


DOTS = {"": "float32", ".bf16": "bfloat16", ".int8": "int8"}


def fused_per_clip(tree: Path, randn, sfxs=tuple(DOTS)) -> dict:
    """Kernels D and E (the instances of ``sfxs``: "" float32, ".bf16",
    ".int8") and their A + B chains at every shape of the fused path of a
    10 s clip at that dtype, weighted by launches."""
    import torch

    from flowhigh_tpu_torch import FlowHighConfig, ops
    import chip_smoke  # the tree's (main puts TREE first on the path)
    if not Path(chip_smoke.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {chip_smoke.__file__}, not {tree}")
    cfg = FlowHighConfig().vocoder
    out: dict = {}
    for sfx in sfxs:
        dt = getattr(torch, DOTS[sfx])
        calls = chip_smoke.main_path_calls(
            cfg, 1000, True, None if dt == torch.float32 else dt)
        for key, n in calls["act_conv1d" + sfx].items():
            _, c, t, k, d, n_res, scale = key
            x = randn(1, c, t)
            a, b = randn(c, scale=0.3), randn(c, scale=0.3)
            w, bias = randn(c, c, k, scale=(c * k) ** -0.5), randn(
                c, scale=0.1)
            rs = tuple(randn(1, c, t) for _ in range(n_res))
            kw = dict(dilation=d, residuals=rs, out_scale=scale, dot_dtype=dt)
            ms = n * time_ms(lambda: ops.act_conv1d(x, a, b, True, w, bias,
                                                    **kw))
            chain = n * time_ms(lambda: ops.conv1d(
                ops.snake_activation1d(x, a, b, True), w, bias, **kw))
            _add(out, f"D{sfx}", c, k, d, ms, chain)
            del x, rs
        for key, n in calls["amp_unit" + sfx].items():
            c, t, k, d, n_extra, scale = key
            x = randn(1, c, t, scale=0.5)
            a1, b1, a2, b2 = (randn(c, scale=0.3) for _ in range(4))
            w1, w2 = (randn(c, c, k, scale=(c * k) ** -0.5) for _ in range(2))
            bias1, bias2 = randn(c, scale=0.1), randn(c, scale=0.1)
            ex = tuple(randn(1, c, t) for _ in range(n_extra))

            def chain():
                h = ops.conv1d(ops.snake_activation1d(x, a1, b1, True), w1,
                               bias1, dilation=d, dot_dtype=dt)
                return ops.conv1d(ops.snake_activation1d(h, a2, b2, True), w2,
                                  bias2, residuals=(x,) + ex, out_scale=scale,
                                  dot_dtype=dt)
            ms = n * time_ms(lambda: ops.amp_unit(
                x, a1, b1, a2, b2, True, w1, bias1, w2, bias2, dilation=d,
                extra_residuals=ex, out_scale=scale, dot_dtype=dt))
            _add(out, f"E{sfx}", c, k, d, ms, n * time_ms(chain))
            del x, ex
    return out


def _add(out: dict, name: str, c: int, k: int, d: int, ms: float,
         chain: float) -> None:
    for grp in (f"{c} {k} {d}", f"{c} sum", "sum"):
        for key, v in ((f"{name} {grp}", ms), (f"{name} chain {grp}", chain)):
            out[key] = out.get(key, 0.0) + v


FLAGS = ("--fused", "--conv", "--act", "--flash", "--fir", "--field",
         "--int8")


def graph_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Mean device ms of ``fn``'s launches: ``reps`` calls captured in one
    CUDA graph and replayed, so no host work sits between the launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


G_LANES = 384  # probe G's lanes (C * T of every stage is a multiple)


def host_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Mean host ms of one call of ``fn`` (its enqueue: the wrapper's
    checks, its allocation and the launch), the card left to run."""
    import time

    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def act_per_clip(tree: Path, randn) -> dict:
    """Kernel A (wrapper and device time), its firs-only instance, probe G
    and the bytes bound at every shape of the unfused and default paths of
    a 10 s clip, weighted by launches."""
    import torch

    from flowhigh_tpu_torch import FlowHighConfig, ops
    import chip_smoke  # the tree's (main puts TREE first on the path)
    cfg = FlowHighConfig().vocoder
    bw = chip_smoke.PEAKS["sxm"][1]
    per_shape = {}
    for c, t in sorted(set(chip_smoke.main_path_calls(
            cfg, 1000, False)["snake_aa"]), reverse=True):
        x = randn(1, c, t)
        a, b = randn(c, scale=0.3), randn(c, scale=0.3)
        xg = randn(1, c * t // G_LANES, G_LANES)
        ab = torch.exp(randn(2, G_LANES, scale=0.3))
        per_shape[c, t] = {
            "A": time_ms(lambda: ops.snake_activation1d(x, a, b, True)),
            "A host": host_ms(lambda: ops.snake_activation1d(x, a, b, True)),
            "A graph": graph_ms(lambda: ops.snake_activation1d(x, a, b, True)),
            "A.firs": time_ms(lambda: ops.act_firs_only(x)),
            "G": time_ms(lambda: ops.snake_only(xg, ab)),
            "A bound": chip_smoke.work("snake_aa", (c, t))[0] / bw * 1e3}
        del x, xg
        torch.cuda.empty_cache()
    res: dict = {}
    for fuse, grp in ((False, "sum"), (True, "default")):
        calls = chip_smoke.main_path_calls(cfg, 1000, fuse)["snake_aa"]
        for (c, t), n in calls.items():
            for name, ms in per_shape[c, t].items():
                keys = [f"{name} {grp}"] + ([f"{name} {c} sum"] if grp ==
                                            "sum" else [])
                for key in keys:
                    res[key] = res.get(key, 0.0) + n * ms
    return res


# kernel F: (name, B, N, valid frames of each row); the long-form clip's
# vector field launches F twice (depth 2)
FLASH_AB = (("30000", 1, 30000, (30000,)), ("1000 b1", 1, 1000, (1000,)),
            ("1000 b2", 2, 1000, (1000, 1000)),
            ("1000 b2 masked", 2, 1000, (950, 998)))
FLASH_HEADS, FLASH_DIM, FLASH_SCALE, FLASH_PER_CLIP = 16, 64, 10.0, 2


def flash_per_shape(randn, errors: dict) -> dict:
    """Kernel F through its wrapper and in a CUDA graph at ``FLASH_AB``;
    at N = 1,000 its max abs difference from the plain version in float32
    and in float64, and the float32 plain version's from the float64 one,
    into ``errors``."""
    import torch

    from flowhigh_tpu_torch import ops
    res: dict = {}
    for name, b, n, valids in FLASH_AB:
        q, k, v = (randn(b, FLASH_HEADS, n, FLASH_DIM) for _ in range(3))
        mask = (torch.arange(n, device="cuda")[None, :]
                < torch.tensor(valids, device="cuda")[:, None])
        reps = 5 if n > 4096 else 15

        def run():
            return ops.flash_attention(q, k, v, mask, FLASH_SCALE)
        if n <= 4096:
            got = run().double()
            p32 = ops.flash_attention_plain(q, k, v, mask, FLASH_SCALE).double()
            p64 = ops.flash_attention_plain(q.double(), k.double(), v.double(),
                                            mask, FLASH_SCALE)
            errors.update({f"F vs plain32 {name}": float((got - p32).abs().max()),
                           f"F vs plain64 {name}": float((got - p64).abs().max()),
                           f"plain32 vs plain64 {name}":
                               float((p32 - p64).abs().max())})
            del got, p32, p64
        res[f"F {name}"] = time_ms(run, reps, 1)
        res[f"F graph {name}"] = graph_ms(run, reps, 1)
        del q, k, v, mask
    for key in ("F", "F graph"):
        res[f"{key} clip"] = FLASH_PER_CLIP * res[f"{key} 30000"]
    return res


# kernel H: (instance, weight dtype, snake) and the probe cases with p > 1
FIR_INSTANCES = (("f32", "float32", True), ("f32_dots", "float32", False),
                 ("bf16", "bfloat16", True), ("bf16_dots", "bfloat16", False))


def fir_per_case(tree: Path, errors: dict) -> dict:
    """Kernel H's four instances at the probe script's cases with p > 1:
    wrapper and CUDA-graph times, plain times, bounds (see the module
    docstring); each instance's error against its plain version into
    ``errors``."""
    import torch

    from flowhigh_tpu_torch import ops
    import chip_smoke  # the tree's (main puts TREE first on the path)
    bench = chip_smoke._load_probe_script()
    peaks = chip_smoke.PEAKS["sxm"]
    rng = np.random.default_rng(0)  # the probe script's draws, in order
    res: dict = {}
    for name, s, c, p in bench.CASES:
        inp = bench.case_inputs(rng, s, c, p, "cuda")
        if p == 1:
            continue
        case = name.split()[0]
        ops_ = 24.0 * s * (p * c) ** 2  # both products, either instance
        keys = {"H bound bf16": ops_ / peaks[2] * 1e3,
                "H bound f32": 3 * ops_ / peaks[4] * 1e3,
                "H bound f32 fma": ops_ / peaks[0] * 1e3}
        for label, dt, snk in FIR_INSTANCES:
            sfx = "_bf16" if dt == "bfloat16" else ""
            args = (inp["x"], inp["up" + sfx], inp["dn" + sfx], inp["ab2"])

            def run(args=args, snk=snk):
                return ops.mxu_fir(*args, do_snake=snk)

            def plain(args=args, snk=snk):
                return ops.mxu_fir_plain(*args, do_snake=snk)
            want, got = plain().double(), run().double()
            diff = (got - want).abs()
            errors[f"H {label} {case}"] = (
                float(diff.norm() / want.norm()) if dt == "bfloat16"
                else float(diff.max() / want.abs().max()))
            del got, want, diff
            keys.update({f"H {label}": time_ms(run, 10, 2),
                         f"H graph {label}": graph_ms(run, 10, 2),
                         f"H plain {label}": time_ms(plain, 3, 1)})
        for key, ms in keys.items():
            res[f"{key} {case}"] = ms
            res[f"{key} sum"] = res.get(f"{key} sum", 0.0) + ms
        del inp
        torch.cuda.empty_cache()
    return res


def conv_per_clip(randn, sfxs=tuple(DOTS)) -> dict:
    """Kernel B (the instances of ``sfxs``) at every conv of the unfused
    path of a 10 s clip, weighted by launches; conv_post (float32 under
    int8) with the float32 and bfloat16 instances."""
    import torch

    from flowhigh_tpu_torch import ops
    res: dict = {}
    for sfx in sfxs:
        name, dt = "B" + sfx, getattr(torch, DOTS[sfx])
        sums: dict = {}
        for (c, t, k, d, n_res, scale), n in unfused_convs().items():
            x = randn(1, c, t)
            w, bias = randn(c, c, k, scale=(c * k) ** -0.5), randn(
                c, scale=0.1)
            rs = tuple(randn(1, c, t) for _ in range(n_res))
            ms = n * time_ms(lambda: ops.conv1d(
                x, w, bias, dilation=d, residuals=rs, out_scale=scale,
                dot_dtype=dt))
            for grp in (f"{name} {c} {k} {d}", f"{name} {c} sum",
                        f"{name} sum"):
                sums[grp] = sums.get(grp, 0.0) + ms
            del x, w, rs
        if dt != torch.int8:
            x = randn(1, 48, 480000)
            w, bias = randn(1, 48, 7, scale=(48 * 7) ** -0.5), randn(1)
            sums[f"{name} post"] = time_ms(lambda: ops.conv1d(
                x, w, bias, dot_dtype=dt))
            sums[f"{name} sum"] += sums[f"{name} post"]
        res.update(sums)
    return res


# ``--field``'s configurations: ModelConfig fields over the published
# defaults (chip_smoke.py phase 2's field and phase V's)
FIELDS = {"f32": {}, "convnext": dict(architecture="convnext"),
          "options": dict(num_register_tokens=16,
                          use_unet_skip_connection=True,
                          use_gateloop_layers=True),
          "bf16": dict(compute_dtype="bfloat16")}


def field_per_config() -> dict:
    """The vector field's times (see the module docstring, ``--field``)."""
    import time

    import torch

    from flowhigh_tpu_torch import FlowHighConfig, FlowHighSR
    from flowhigh_tpu_torch.compat import seeded_init_
    from flowhigh_tpu_torch.config import ModelConfig
    from flowhigh_tpu_torch.dsp import resample_poly
    from flowhigh_tpu_torch.models import (VectorFieldNet,
                                           forward_with_cond_scale,
                                           mel_encode)
    from flowhigh_tpu_torch.profiling import clip_signal

    def host_wall(fn, reps: int) -> float:
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls))

    audio = resample_poly(torch.from_numpy(clip_signal(10.0, 16000))[None]
                          .cuda(), 48000, 16000)
    audio = audio / audio.abs().max()
    sr = FlowHighSR(FlowHighConfig(), cfm_method="independent_cfm_adaptive",
                    ode_method="adaptive", device="cuda")
    sr.init_params(0)

    def solve():
        return sr.sample(cond=audio, decode_to_audio=False).cpu()
    solve()
    res = {"sample dopri5 host": host_wall(solve, 5)}
    del sr
    with torch.inference_mode():
        mel = mel_encode(audio)
        mask = torch.ones(mel.shape[:2], dtype=torch.bool, device="cuda")
        t = torch.zeros((), device="cuda")
        for name, opts in FIELDS.items():
            try:
                net = VectorFieldNet(ModelConfig(**opts))
            except NotImplementedError:  # an option the tree does not port
                continue
            if "compute_dtype" in opts and not hasattr(net, "dtype"):
                continue  # a tree that computes in float32 only
            net = seeded_init_(net.eval(), 0).cuda()

            def call():
                return forward_with_cond_scale(net, mel, times=t, cond=mel,
                                               mask=mask)
            for _ in range(5):
                call()
            ev = []
            for _ in range(30):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call()
                b.record()
                b.synchronize()
                ev.append(a.elapsed_time(b))
            res[f"field {name}"] = float(np.median(ev))
            res[f"field {name} loop7 host"] = host_wall(
                lambda: [call() for _ in range(7)], 10)
            del net
    return res


def main() -> int:
    args = [a for a in sys.argv[1:] if a not in FLAGS]
    sfxs = (".int8",) if "--int8" in sys.argv[1:] else tuple(DOTS)
    fused_only = "--fused" in sys.argv[1:]
    conv_only = "--conv" in sys.argv[1:]
    act_only = "--act" in sys.argv[1:]
    flash_only = "--flash" in sys.argv[1:]
    fir_only = "--fir" in sys.argv[1:]
    field_only = "--field" in sys.argv[1:]
    tree = Path(args[0] if args
                else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import flowhigh_tpu_torch
    from flowhigh_tpu_torch import ops
    if not Path(flowhigh_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {flowhigh_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("port_kernel_ab.py needs a CUDA card")

    gen = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                                * np.float32(scale)).cuda()

    res = {}
    if field_only:
        return report(tree, field_per_config())
    if act_only:
        return report(tree, act_per_clip(tree, randn))
    if flash_only:
        errors: dict = {}
        return report(tree, flash_per_shape(randn, errors), errors)
    if fir_only:
        errors = {}
        return report(tree, fir_per_case(tree, errors), errors)
    if not conv_only:
        res.update(fused_per_clip(tree, randn, sfxs))
    if not fused_only:
        res.update(conv_per_clip(randn, sfxs))
    if fused_only or conv_only or sfxs == (".int8",):
        return report(tree, res)
    for name, dt in (("C", torch.float32), ("C.bf16", torch.bfloat16)):
        total = 0.0
        for cin, cout, t, u, k in UPSAMPLERS:
            x = randn(1, cin, t)
            w, bias = randn(cin, cout, k, scale=(cout * k) ** -0.5), randn(
                cout, scale=0.1)
            ms = time_ms(lambda: ops.conv_transpose1d(x, w, bias, stride=u,
                                                      dot_dtype=dt))
            res[f"{name} {cin} {u} {k}"] = ms
            total += ms
        res[f"{name} sum"] = total
    return report(tree, res)


def report(tree: Path, res: dict, errors=None) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    line = {"tree": str(tree), "card": card,
            "ms": {k: round(v, 3) for k, v in res.items()}}
    if errors:
        line["max_abs"] = errors
    print(json.dumps(line))
    return 0

if __name__ == "__main__":
    raise SystemExit(main())
