#!/usr/bin/env python3
"""Smoke run of flowhigh_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

0. print the card (nvidia-smi name, power limit) and build the CUDA kernels
   from flowhigh_tpu_torch/csrc with nvcc (all sources in parallel);
1. hold every vocoder kernel against its plain PyTorch version on the card
   at every shape a 10 s, 16 kHz clip gives it on both vocoder paths, the
   default (``fuse_act_conv=True``: kernels A-E) and the unfused one
   (``fuse_act_conv=False``: A, B, C), and at every shape of the long-form
   path's vocoder windows (1,064 frames), atol 1e-4, rtol 1e-4; time the
   kernel, the plain version and the one PyTorch library call that computes
   the same function where there is one (CUDA events, median of 15 after 3
   warm-up launches). No single PyTorch call computes kernel D or E; their
   yardstick is the port's own unfused chain of kernels A and B for the same
   work (``unfused_chain_ms``). Kernel F (flash attention) is held against
   its plain version (evaluated in float64) over every row, masked rows
   included, at H = 16, D = 64, B in {1, 2} and N in {128, 1,000 (950
   valid), 4,096 (4,000 valid)}: atol 1e-4 within one block, max 5e-3 and mean 1e-4 over
   several; at the long-form shape, N = 30,000, 256 random query rows per
   head against an exact float64 softmax. Its yardstick is
   ``F.scaled_dot_product_attention`` with a boolean segment mask on the
   memory-efficient backend. The reduced-precision instances (B.bf16,
   B.int8, C.bf16, D.bf16, D.int8, E.bf16, E.int8; ``ops/quant.py``) are
   held the same way at every shape of the 10 s bf16 and int8 paths, fused
   and unfused: B and C at atol / rtol 1e-4, D and E in relative L2 and
   scaled max abs (``STAT_TOL``); timed beside their float32 instance (``f32_ms``),
   the PyTorch conv on bf16 tensors as the bf16 library call (int8 has
   none) and the A + B chain at the same dtype for D and E; bounds at the
   data-sheet tensor-core peak of their dtype. The float32 instances of
   kernel C, of kernel B's GEMM route and of kernels D and E, and both
   products of kernel F, run 3xTF32 on the tensor cores, so their bounds
   count three TF32 products per f32 product at the TF32 peak
   (``DOT_UNITS``), F's softmax at the f32 peak (``SOFTMAX_OPS`` a
   score); B's narrow route (``conv_post``) runs on the FMA units. B.int8, D.int8 and E.int8 run
   s8 ``mma.sync`` after a pre-pass launch for their window scales (both
   in their ms); they equal their plain versions exactly (max abs 0.0; D
   and E held at ``STAT_TOL`` like the other variants, B.int8 at ATOL /
   RTOL, and phase 1 fails if B.int8 differs at all). The instances on
   bf16 feature maps (``@bf16``: A, B at every dot dtype on both routes
   with B.int8's pre-pass, D and E at every dot dtype;
   ``ops.STORAGE_VARIANTS``) are held the same way at every shape of the
   10 s bf16-map paths (fused and unfused, each dot dtype), one bf16 step
   more allowed on a few of their outputs (``BF16_FLIP_SHARE``), the int8
   ones bit-equal; timed (``REPS_BF16_MAPS`` launches) beside the same dot
   dtype's instance on float32 maps (``f32_ms``), their bounds counting 2
   bytes a map element. Phase 0 prints each kernel instance's registers and spills
   (ptxas) and fails if an instance of B (GEMM and narrow route, any dot
   dtype), a tensor-core instance of D or E (float32, bfloat16, int8), an
   int8 pre-pass, an instance of kernel A, probe G, an instance of kernel
   F or an instance of probe H (with its prep kernels) spills, on float32
   and bf16 maps alike; kernel C's spills, on both maps, are printed in
   one line (C stays outside ``NO_SPILL``). Kernel C on bf16 maps
   (``conv_transpose1d[.bf16]@bf16``, the compute dtype bf16) is held and
   timed at phase X's shapes like the other instances on bf16 maps, with
   no library call at f32 dots. C's rows per upsampler of the 10 s
   clip (f32 and bf16, on both maps) are printed, and B's per resblock shape of the
   unfused 10 s clip (stage x K x d, f32, bf16 and int8) and its
   ``conv_post`` row;
2. run FlowHighSR.generate at full width (FlowHighConfig() defaults, seeded
   random weights) on a 10 s, 16 kHz clip, first on the default path, then
   on the unfused path: launch counts of every kernel on each run (zeroed
   just before, read just after, held against ``main_path_calls``), output
   shape and finiteness, the two paths' outputs against each other, median
   ms per clip and RTF of each; on one more unfused run, the largest
   argument |a u| that kernel A's sine meets (``snake_arguments``), which
   must lie within the range its error bound is stated for (2^15);
serving: ServingPipeline over 12 x 10 s clips with at most 8 in flight,
   float32 and int16 wire: sustained RTF; a pinned-seed request against
   ``generate``; ``generate_batch`` on 4 clips at 16 and 8 kHz against
   per-clip ``generate`` (max abs diff <= 1e-4);
3. run a 1 s clip through the same weights on the card (default path) and
   on the CPU (plain versions): max abs waveform difference <= 1e-3; also
   report the card-vs-CPU difference of the log-mel (float32 and float64
   STFT) and of the vocoder alone on one mel;
P. the reduced-precision vocoder: ``vocoder_conv_dtype`` bfloat16, then
   int8, each on the fused and the unfused path, on phase 2's 10 s clip and
   weights: launch counts against ``main_path_calls`` (every variant of the
   path launched), output shape and finiteness, median ms per clip of 5 and
   RTF, relative L2 (``FROM_F32``) and waveform LSD against phase 2's
   float32 output. Then phase 3 at each dtype: the 1 s clip on the card,
   with every kernel launch of that run held against its plain version on
   its own inputs (``replayed``), and on the CPU; the card's distance from
   its float32 output within 1.5x the CPU's. The reduced-precision vocoder
   amplifies f32 rounding (an f32 ulp that moves one activation across a
   bf16 rounding or an int8 quantisation boundary changes the next layer's
   inputs by far more than an ulp, and so on down the network), so the card
   is held to the CPU within max(1e-2, twice the CPU's own change under
   input nudges of +-2^-16, the order of the float32 card-vs-CPU
   difference). Then the same on bf16 feature maps
   (``vocoder_storage_dtype=bfloat16``, ``storage_phase``) at float32,
   bfloat16 and int8 dots, fused and unfused: launch counts (every
   instance on bf16 maps of the path launched), ms per clip, rel L2
   (``FROM_F32`` of the dot dtype) and LSD against phase 2's output, every
   launch of a 1 s run replayed against its plain version (the int8 ones
   bit-equal), and, fused, the 1 s card-vs-CPU check above;
X. the vocoder's compute dtype (``compute_phase``): ``MelVoco(dtype=
   torch.bfloat16)``, fused, at float32, bfloat16 and int8 dots, with
   phase 2's vocoder weights on the mel phase 2's 10 s clip hands its
   vocoder (``vocoder_mel``): launch counts of one ``decode`` against
   ``main_path_calls`` (kernel C on bf16 maps 5 a clip), output shape and
   finiteness, ms per decode (median of 5) beside the float32-compute and
   the bf16-map vocoders at the same dots, timed in turns, rel L2
   (``FROM_F32``) and waveform LSD against the float32 vocoder's output
   of that mel; on its first second every launch replayed against its
   plain version, and the card against the CPU under phase 3's rule for
   reduced precision (the mel nudged by +-2^-16);
L. long-form: the same weights with ``ModelConfig(attn_flash=True)`` run
   ``generate_longform`` single-pass on a 300 s, 16 kHz clip (vocoder
   windows of 1,000 + 2 x 32 frames): launch counts (F 2, the vocoder's per
   window x 30), output shape and finiteness, wall time (median of 3 after
   the counted run) as RTF, peak device memory, device ms of F against the
   vocoder (torch.profiler, one run). Checks on 10 s: ``generate_longform``
   against ``generate`` (<= 2e-4), ``vocode_chunked`` against the whole
   vocoder on a 2,000-frame mel (<= 1e-5), the flash model's ``generate``
   against phase 2's dense one (<= 1e-3). StreamingSR on a 60 s clip (10 s
   chunks, 1 s overlap): RTF on the float32 and int16 wires (median of 3
   runs each), int16 within
   1e-4 of float32, seam LSD against the single-pass output below
   max(2.0, 2.5 x overall LSD);
S. the rest of the inference surface, at full width with phase 2's
   seeded weights. S1: ``generate`` on phase 2's 10 s clip with
   ``ode_method="adaptive"`` (dopri5) and ``use_torchode=True`` (tsit5)
   at atol = rtol = 1e-5 through ``dispatch_generate`` (its third result,
   the solver's statistics): n_loops, n_accepted, converged, ms per clip,
   the launch counts of phase 2; on a 1 s clip card and CPU within 1e-3
   with equal accepted steps, or, after a flipped accept, the two solved
   mels' RMS difference within the solver's tolerance (one atol + rtol
   max|y| a step). S2: ``sample()`` (4 steps of the model's solver,
   cond_scale 2, mel_pp, decode_to_audio) on the 10 s clip's mel and on
   its audio, phase 2's launch counts; 1 s card vs CPU within 1e-3. S3: a
   ``VocoderConfig(resblock="2")`` vocoder (AMPBlock2) at 1,536 channels
   on the 10 s mel: kernels A and B 46 launches each and C 5
   (``main_path_calls``), every launch replayed against its plain version
   on its own inputs (``replayed``), ms per clip, 1 s card vs CPU within
   1e-3; phase 1 times its A and B shapes (``resblock2_path`` in the
   records). S4: ``generate(upsampling_method="librosa")`` (the soxr_hq
   FIR) at 16 and 44.1 kHz, ``encode_torchaudio`` and
   ``post_process_with_phase``, each card vs CPU on 1 s
   (``SURFACE_TOL``);
V. the vector field's options, at full width with phase 2's seeded
   vocoder on phase 2's 10 s clip: V1 ``ModelConfig(architecture=
   "convnext")`` (8 blocks of 1,024 x 3,072, the reference's flow.py:124-
   139); V2 the published transformer with 16 register tokens, U-Net skips
   and GateLoop layers, dense and with ``attn_flash=True``; V3 the
   published transformer at ``compute_dtype="bfloat16"``. For each: the
   vocoder's launch counts of phase 2 (and kernel F twice, one a layer, on
   the flash run), output shape and finiteness, median ms per clip of 5,
   the vector field's device ms a call (CUDA events), and the dtype of
   every conv-embedding, attention and feed-forward output in one field
   call on the card, which must be the compute dtype (bf16 for V3, so
   its products ran in bf16; ``field_stream_dtypes``); V3's rel L2 and LSD
   against phase 2's float32 output (the same weights). On V2's flash run every launch of F is held
   against F's plain version in float64 on its own register-padded q, k,
   v and mask (``flash_replayed``, phase 1's tolerances) and timed at that
   shape (the ``flash_attn@registers`` record), and the flash output
   against the dense one within 1e-3. On 1 s, card against CPU within 1e-3
   for V1 and V2; V3 statistically, as phase 3 holds phase P: rel L2
   within max(1e-2, twice the CPU's own change under +-2^-16 input
   nudges);
T. the vector field's trainer (``flowhigh_tpu_torch.train.Trainer``). T1:
   a small trainer (dim 64, float32, TF32 off) on the card and on the CPU
   with one set of draws per update: update 1's loss and gradient within
   rel L2 ``T1_GRAD_TOL``, the parameters after three updates within
   ``T1_PARAM_TOL``. T2: the published field (dim 1,024, depth 2, 16 x 64
   heads) at ``TrainConfig.batch_size`` 128 of 2-3 s, 48 kHz waves
   (``train_batch``, already on the card), in bf16 compute (the default)
   and float32: ms per update (median of 10 after 3, each ending in a
   synchronize), peak memory, host launches of one update (torch
   .profiler), no port kernel launched, and a loss that falls over 20
   updates of the fixed batch; with ``grad_accum_every=2`` parameters move
   on every second micro-step only. T3: ``attn_flash=True``: ``evaluate``
   on two batches of 16 launches kernel F once a layer a batch (counted,
   then each launch held against its plain version in float64,
   ``flash_replayed``), its ``valid_loss`` within 1e-3 of the dense
   ``evaluate``'s, and a ``train_step`` raises ``ValueError`` (F has no
   backward, as in the JAX package);
D. the training data and the CLI's ``train`` (after phase T). D1: the
   native host-DSP library (``flowhigh_tpu_torch.native``) builds with
   g++ from the checkout, and its ``host_degrade`` on 3 s clips at 4, 8,
   16 and 32 kHz, Chebyshev orders 1, 8 and 11, equals scipy's chain
   (rtol 1e-9, atol 1e-10). D2: clips/s of ``train.batch_iterator`` at
   batch 128 of 3 s synthetic clips (native engine) with 2 and 8 thread
   workers and 8 spawn processes, beside one clip at a time and the
   host's CPU count. D3: the device ``dsp.sosfiltfilt`` (the sosfilt
   kernel, ``csrc/sosfilt.cu``, two launches) against its plain version
   (the loop over time, on the CPU) on 2 x 4,000 samples at orders 1, 8
   and 11 (atol 1e-5) and against scipy (2e-3); its launches on a batch's
   3 s crops [128, 144,000], counted, finite, two rows against scipy;
   the kernel timed there (CUDA events) with its bytes bound and its
   serial bound (one thread a row: 9 S float32 instructions a sample and
   pass at the card's largest SM clock); and on [128, 4,000] (padded)
   beside its plain version on the card, which launches ~9 S operations
   a sample (the ``kernels`` line's row). D4: ``cli.main(["train",
   ...])`` on a reference JSON at the published width (batch 128,
   ``save_model_every`` 3, synthetic corpus, batches uploaded by the
   prefetch threads): 3 updates, then auto-resume to update 4; the wall
   time of each update and the share spent waiting in ``next(data_iter)``;
   then ``Trainer.fit`` on the same iterator with ``device_prefetch=False``
   and one batch's synchronous upload;
W. the vocoder's GAN training (``train.VocoderTrainer``: the generator on
   kernels A, B and C, each carrying its plain version's VJP; D and E
   refuse a gradient). W1: tests/test_torch_vocoder_train.py's tiny GAN on
   the card and the CPU from the same weights and waves, float32: step 1's
   three losses and flat gradient, and the parameters after three steps,
   at phase T1's bounds, each also against twice the CPU's own change
   under a +-2^-16 nudge of the waves (the larger holds; both printed); a
   parameter without a card gradient fails. W2: kernels A, B and C under
   autograd at every shape of the published generator's forward on 16 x
   32 frames: each gradient within rel L2 1e-5 of the plain version's, the
   forward, the Function's backward and the plain backward timed (CUDA
   events), summed over the path's launches (the ``kernels`` line's
   ``gan_train_path``). W3: ``VocoderConfig()``, the default MPD and MRD,
   ``segment_frames=32``, batches of 16 ``VocoderSegmentDataset`` segments
   of ``SyntheticAudioDataset``: ms a GAN step (median of 5 after 2, each
   ending in a synchronize), peak memory, the launches of each step held
   to the unfused path's (A 91, B 91, C 5, D and E none), and one step's
   device time by kernel (torch.profiler), grouped as the port's forward
   kernels, backward-named kernels and the rest;
M. the probe kernels (scripts/port_bench_act_mxu.py, the card's counterpart
   of scripts/bench_act_mxu.py): the probe script's run over its four
   cases with every launch count zeroed just before and read just after
   (kernels A and B, A's firs-only instance, G and H's four instances must
   each have launched); then at each case G, the firs-only instance and H
   (f32 and bf16, with and without the snake; p > 1) against their plain
   versions: G, firs-only and f32 H at atol / rtol 1e-4 on values divided
   by the largest |plain value|, bf16 H in relative L2 (1e-3) and scaled
   max abs (``PROBE_BF16_TOL``); each with its bound (f32 H in 3xTF32
   terms, with its f32 FMA bound printed beside), its plain version's
   time and kernels A and B on the same elements beside it;
I. the CLI on the card: ``cli.main(["infer", ...])`` on phase 2's 10 s
   signal as a 16 kHz int16 wav (random weights at full width, seed 0, as
   phase 2) within 1 int16 step of phase 2's model's ``generate`` on the
   same samples, with phase 2's launch counts; ``--input_dir`` on three
   wavs (16 and 8 kHz, ``--wire int16``) each within 1 step of
   ``generate``; ``vocoder`` on a 1 s, 48 kHz wav (the vocoder's default
   path launches); ``--tiny``, whose (8, 16) and (4, 8) upsamplers take
   kernel C and (5, 10), (3, 6) the library conv (both counts printed),
   within 1e-3 of the same CLI on the CPU;
4. print the ``kernels`` JSON line (per kernel: the default path's launches
   and the per-clip sums over them, the unfused path's in ``unfused_path``,
   the long-form path's in ``longform_path``; kernel F's launches and sums
   are per long-form clip; each variant's on its dtype's fused path, or
   the unfused one for B.int8, which only that path runs; the probe
   kernels' launches from phase M's run, their times summed over the
   probe script's cases, one launch each; A, B and C's AMPBlock2 sums in
   ``resblock2_path``; kernel F's register-padded instance per phase V2
   flash clip; kernel F's launches in phase T3's ``evaluate`` in
   ``evaluate_launches`` and ``evaluate_path``; the sosfilt kernel's
   from phase D3; A, B and C's phase W2 figures in ``gan_train_path``;
   kernel C's instances on bf16 maps on phase X's path of their dots),
   with phase S's, phase V's, phase T's, phase D's and phase W's paths
   (``paths``: name, launches, ms), phase T's summary line
   (``train``), the card line and, last, the ``ok`` line.

Per-shape numbers go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SECONDS, IN_SR = 10.0, 16000
ATOL = RTOL = 1e-4
REPS, WARMUP = 15, 3
# phase 1's timings of the instances on bf16 maps (the script's time):
# (repetitions, warm-up launches) of the kernel and its float32-map
# instance, and of the plain version, library call and A + B chain
REPS_BF16_MAPS, REPS_BF16_MAPS_OTHER = (5, 2), (3, 1)
# long-form: clip, vocoder windows (the JAX package's defaults)
LONG_SECONDS, CHUNK, OVERLAP = 300.0, 1000, 32
STREAM_REPS = 3  # timed StreamingSR runs of each wire (median)

# published peaks (NVIDIA data sheets): f32 FMA-unit FLOP/s, memory B/s,
# dense tensor-core bf16 FLOP/s, int8 OP/s and TF32 FLOP/s
PEAKS = {"sxm": (67e12, 3.35e12, 989e12, 1979e12, 495e12),
         "pcie": (51e12, 2.0e12, 756e12, 1513e12, 378e12),
         "nvl": (60e12, 3.9e12, 835e12, 1671e12, 417e12)}
# instances whose dot products run on another unit than their dtype's:
# the float32 instances of kernel C, of kernel B's GEMM route, of kernels
# D and E (their act->conv core's tensor-core route), kernel F (both
# products) and probe H (both products, with and without the snake) run
# each f32 product as three TF32 products on the tensor cores (3xTF32):
# {instance: (products per dot product, peak)}
DOT_UNITS = {"conv_transpose1d": (3, 4), "conv1d_same": (3, 4),
             "act_conv1d": (3, 4), "amp_unit": (3, 4), "flash_attn": (3, 4),
             "mxu_fir": (3, 4), "mxu_fir.dots": (3, 4)}
# kernel B's narrow route (conv_post) below this Cout: f32 FMA at any dtype
# (flowhigh_tpu_torch/ops/conv.py: NARROW_COUT)
NARROW_COUT = 16
# the entry functions that phase 0 fails on if ptxas reports a spill, on
# float32 and bfloat16 feature maps alike: the tensor-core instances of D
# and E (float32, bfloat16; int8), every instance of B (the GEMM route:
# float32, bfloat16, int8; the narrow route), the int8 instances'
# pre-passes, kernel A's instances (its strip and halo live in registers),
# probe G (A's snake alone), every instance of kernel F (Q's split
# fragments and the running O live in registers) and of probe H (the
# output accumulator lives in registers), with H's prep kernels, and the
# sosfilt kernel (its cascade's coefficients and states live in registers)
NO_SPILL = ("act_conv1d_mma_kernel", "act_conv1d_s8_kernel",
            "amp_unit_mma_kernel", "amp_unit_s8_kernel", "act_amax_kernel",
            "conv1d_mma_kernel", "conv1d_s8_kernel", "conv1d_narrow_kernel",
            "conv1d_amax_kernel", "snake_aa_kernel",
            "snake_only_kernel", "flash_attn_kernel", "fir_tf32_kernel",
            "fir_wgmma_kernel", "fir_pack_f32_kernel", "fir_pack_kernel",
            "sosfilt_kernel")


def dot_seconds(peaks, kernel: str, dots: float, key=None) -> float:
    """The least time of ``dots`` dot-product operations of a kernel
    instance (at shape ``key``, where its route depends on it) on the unit
    its products run on."""
    base, sfx, _ = split_name(kernel)
    kernel = kernel.partition("@")[0]
    if base == "conv1d_same" and sfx != "int8" and key is not None \
            and key[1] < NARROW_COUT:
        return dots / peaks[0]
    if kernel in DOT_UNITS:
        n, peak = DOT_UNITS[kernel]
    else:  # the dtype's own unit
        n, peak = 1, {"": 0, "bf16": 2, "int8": 3}[sfx]
    return n * dots / peaks[peak]


def ptxas_entries(log: str) -> list:
    """(kernel, template arguments, registers, (spill store, spill load
    bytes)) of each entry function in an ``nvcc -Xptxas -v`` log; the
    arguments as ptxas mangles them (``Dot`` as its number, then the
    integers; the storage type ``Store`` as its number too), e.g.
    ``1,11,128,4``."""
    import re
    out = []
    for chunk in log.split("Compiling entry function '")[1:]:
        fn = chunk.split("'")[0]
        # _ZN<n>_GLOBAL__N__<hash>_<n>_<file>_cu_<8 hex>[<n><namespace>...]
        # <n><kernel>I<args>EEv: the kernel is the last length-prefixed name
        m = re.search(r"_cu_[0-9a-f]{8}", fn)
        kern, targs, pos = fn, "", m.end() if m else len(fn)
        while m and pos < len(fn) and fn[pos].isdigit():
            d = re.match(r"\d+", fn[pos:]).group()
            kern = fn[pos + len(d):pos + len(d) + int(d)]
            pos += len(d) + int(d)
        if m and fn.startswith("I", pos):
            t = re.match(r"I(.*?)EEv", fn[pos:])
            targs = t.group(1) if t else ""
        args = ",".join(re.findall(r"(?:DotE|StoreE|Li)(\d+)E",
                                   targs + "E"))
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", chunk)
        out.append((kern, args, int(regs.group(1)) if regs else -1,
                    (int(spill.group(1)), int(spill.group(2))) if spill
                    else (0, 0)))
    return out


def sm_clock_mhz():
    """The card's largest SM clock in MHz (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def card_peaks(name: str) -> tuple:
    low = name.lower()
    if "pcie" in low:
        return PEAKS["pcie"]
    if "nvl" in low:
        return PEAKS["nvl"]
    return PEAKS["sxm"]


# --- main-path shapes of a clip -------------------------------------------------

KERNEL_NAMES = ("snake_aa", "conv1d_same", "conv_transpose1d", "act_conv1d",
                "amp_unit")  # the vocoder's, in ops.KERNELS order
FLASH = "flash_attn"
ALL_KERNELS = KERNEL_NAMES + (FLASH,)
# the reduced-precision instances, in ops.VARIANTS order: kernel.suffix
VARIANT_NAMES = ("conv1d_same.bf16", "conv1d_same.int8",
                 "conv_transpose1d.bf16", "act_conv1d.bf16", "act_conv1d.int8",
                 "amp_unit.bf16", "amp_unit.int8")
SUFFIXES = {"bf16": "bfloat16", "int8": "int8"}  # suffix -> torch dtype name
# the instances on bfloat16 feature maps (``vocoder_storage_dtype``; kernel
# C's with the vocoder's compute dtype bf16), in ops.STORAGE_VARIANTS
# order: kernel[.dot suffix]@bf16
BF16_MAPS = "@bf16"
CONVT_BF16_MAPS = ("conv_transpose1d@bf16", "conv_transpose1d.bf16@bf16")
STORAGE_NAMES = ("snake_aa@bf16",) + tuple(
    f"{k}{s}@bf16" for k in ("conv1d_same", "act_conv1d", "amp_unit")
    for s in ("", ".bf16", ".int8")) + CONVT_BF16_MAPS


def split_name(name: str) -> tuple:
    """(kernel, dot suffix or "", bf16 maps?) of an instance name."""
    inst, at, _ = name.partition("@")
    base, _, sfx = inst.partition(".")
    return base, sfx, bool(at)


def suffix(dot_dtype) -> str:
    """"" for float32 (or None), ".bf16", ".int8": the instance's name."""
    name = str(dot_dtype).replace("torch.", "")
    return {"None": "", "float32": "", "bfloat16": ".bf16",
            "int8": ".int8"}[name]


def dot_dtype_of(name: str):
    """The torch dtype of an instance name (``kernel`` or ``kernel.sfx``)."""
    import torch
    sfx = split_name(name)[1]
    return getattr(torch, SUFFIXES[sfx]) if sfx else torch.float32


def main_path_calls(cfg, frames: int, fuse_act_conv=True, conv_dtype=None,
                    storage_dtype=None, dtype=None):
    """Every kernel call of one BigVGAN forward over ``frames`` mel frames,
    routed as ``models/bigvgan.py`` routes it (the port's plans; AMPBlock2
    on kernels A and B whatever ``fuse_act_conv``) for the vocoder's
    ``conv_dtype``: {instance: {shape key: launches}} over the
    five kernels and, for bf16 or int8, that dtype's variants; the
    resblock convs at ``conv_dtype``, the upsamplers and conv_post at
    bfloat16 under bfloat16 and float32 under int8 (``boundary_dtype``).
    With ``storage_dtype`` bfloat16, the instances on bf16 maps (``@bf16``)
    where the vocoder's dtype flow reads bf16 (the module docstring of
    models/bigvgan.py): AMPBlock1's launches and activation_post, conv_post
    where the last stage packs, and AMPBlock2 by its stage's packing.
    AMPBlock2's convs and conv_post take float32 dots where their stage
    does not pack, as in the JAX package. With the compute ``dtype``
    bfloat16 (``BigVGAN(dtype=)``): the upsamplers on bf16 maps at the
    boundary dtype (``conv_transpose1d[.bf16]@bf16``), the rest as on bf16
    maps, except that where a stage does not pack AMPBlock2's convs and
    conv_post are the JAX package's bf16 XLA conv (``conv1d_same.bf16@bf16``,
    no residual: the f32 bias and x are added after it).
    Keys: snake (C, T); conv and act_conv (Cin, Cout, T, K, d, n_res,
    out_scale); convt (Cin, Cout, T_in, u, K); amp_unit (C, T, K, d,
    n_extra, out_scale)."""
    from flowhigh_tpu_torch.models import BigVGAN
    from flowhigh_tpu_torch.ops import act_conv_plan, amp_unit_plan
    res = suffix(conv_dtype)
    bnd = "" if res == ".int8" else res
    calls = {k: {} for k in KERNEL_NAMES + tuple(
        v for v in VARIANT_NAMES if res and v.endswith(res))}

    def add(kernel, key, n=1):
        calls.setdefault(kernel, {})
        calls[kernel][key] = calls[kernel].get(key, 0) + n

    ch, t = cfg.upsample_initial_channel, frames
    nk = len(cfg.resblock_kernel_sizes)
    bf16c = str(dtype).replace("torch.", "") == "bfloat16"  # compute dtype
    # the maps' suffix
    st = BF16_MAPS if storage_dtype is not None or bf16c else ""
    xla_bf16 = "conv1d_same.bf16" + BF16_MAPS  # XLA's bf16 conv at p = 1

    def pair(ch, t, k, d, n_res, scale):
        fuse = k <= 3 if fuse_act_conv == "auto" else bool(fuse_act_conv)
        if fuse and act_conv_plan(k, d, ch, t):
            add("act_conv1d" + res + st, (ch, ch, t, k, d, n_res, scale))
        else:
            add("snake_aa" + st, (ch, t))
            add("conv1d_same" + res + st, (ch, ch, t, k, d, n_res, scale))

    p = 1
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cout = cfg.upsample_initial_channel // 2 ** (i + 1)
        add("conv_transpose1d" + bnd + (BF16_MAPS if bf16c else ""),
            (ch, cout, t, u, k))
        ch, t = cout, t * u
        p = BigVGAN._pack_factor(ch, t)
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            for m, d in enumerate(rd):
                if cfg.resblock == "2":  # AMPBlock2: A, then B with x added
                    if st and p > 1:  # the conv rounds, + bias, + x in bf16
                        add("snake_aa" + st, (ch, t))
                        add("conv1d_same" + (res or ".bf16") + st,
                            (ch, ch, t, rk, d, 0, 1.0))
                    elif p > 1:
                        add("snake_aa", (ch, t))
                        add("conv1d_same" + res, (ch, ch, t, rk, d, 1, 1.0))
                    elif bf16c:  # the first act on bf16 maps; bf16 convs
                        add("snake_aa" + (st if m == 0 else ""), (ch, t))
                        add(xla_bf16, (ch, ch, t, rk, d, 0, 1.0))
                    else:  # float32 dots; the first act on bf16 maps
                        add("snake_aa" + (st if m == 0 else ""), (ch, t))
                        add("conv1d_same", (ch, ch, t, rk, d, 1, 1.0))
                    continue
                last = j == nk - 1 and m == len(rd) - 1
                n_extra, scale = (nk - 1, 1.0 / nk) if last else (0, 1.0)
                if fuse_act_conv is True and amp_unit_plan(rk, d, ch, t):
                    add("amp_unit" + res + st,
                        (ch, t, rk, d, n_extra, scale))
                    continue
                pair(ch, t, rk, d, 0, 1.0)
                pair(ch, t, rk, 1, 1 + n_extra, scale)
    # at the end the map is bf16 unless AMPBlock2 promoted it at p = 1
    end = st if cfg.resblock == "1" or p > 1 else ""
    add("snake_aa" + end, (ch, t))
    # conv_post: where the last stage does not pack float32 dots and maps,
    # or at bf16 compute XLA's bf16 conv
    post = (ch, 1, t, 7, 1, 0, 1.0)
    add("conv1d_same" + bnd + end if p > 1 else xla_bf16 if bf16c
        else "conv1d_same", post)
    return calls


def longform_calls(cfg, frames: int, chunk: int = CHUNK,
                   overlap: int = OVERLAP):
    """``main_path_calls`` of ``FlowHighSR.vocode_chunked``: one whole
    forward when ``frames`` fits one window, else ceil(frames / chunk)
    windows of chunk + 2 * overlap frames."""
    window = chunk + 2 * overlap
    if frames <= window:
        return main_path_calls(cfg, frames)
    n = -(-frames // chunk)
    return {k: {key: c * n for key, c in v.items()}
            for k, v in main_path_calls(cfg, window).items()}


SNAKE_OPS = 56.0  # per sample: 2 x 6 up taps, snake on 2 samples, 12 down


def work(kernel: str, key) -> tuple[float, float, float]:
    """(bytes moved: each input read once, each output written once, the
    feature maps (x, residuals, y) in their storage dtype, 4 bytes an
    element or 2 on bf16 maps, the parameters float32 as the port stores
    them; the dot products' operations, at the instance's dot dtype; the
    other operations, float32) of one call of ``kernel`` (an instance name:
    ``conv1d_same``, ``act_conv1d.int8``, ``amp_unit.bf16@bf16``)."""
    kernel, _, bf16_maps = split_name(kernel)
    e = 2.0 if bf16_maps else 4.0  # bytes a map element
    if kernel == "snake_aa":
        c, t = key
        return e * 2 * c * t + 4.0 * (2 * c + 12), 0.0, SNAKE_OPS * c * t
    if kernel in ("conv1d_same", "act_conv1d"):
        cin, cout, t, k, _, n_res, _ = key
        byt = (e * (cin * t + (n_res + 1) * cout * t)
               + 4.0 * (cout * cin * k + cout))
        dots, other = 2.0 * cin * cout * k * t, (n_res + 2.0) * cout * t
        if kernel == "act_conv1d":
            return (byt + 4.0 * (2 * cin + 12), dots,
                    other + SNAKE_OPS * cin * t)
        return byt, dots, other
    if kernel == "amp_unit":
        c, t, k, _, n_extra, _ = key
        byt = (e * (c * t + (n_extra + 1) * c * t)
               + 4.0 * (2 * c * c * k + 2 * c + 4 * c + 12))
        return (byt, 4.0 * c * c * k * t,
                2 * SNAKE_OPS * c * t + (n_extra + 3.0) * c * t)
    cin, cout, t, u, k = key
    return (e * (cin * t + cout * u * t) + 4.0 * (cin * cout * k + cout),
            2.0 * cin * cout * k * t, float(cout * u * t))


# --- timing --------------------------------------------------------------------

def time_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median of ``reps`` single-launch CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# Kernels D and E under bf16 / int8 against their plain versions: the
# kernel's snake and the plain one (cuDNN resamplers) differ by f32
# rounding, which now and then moves an activation across a bf16 rounding
# or an int8 quantisation boundary; each such flip moves outputs by one
# bf16 step or one quantum of that activation times a weight, a small
# share of the output's own scale. So they are held in relative L2 and in
# max abs over max(1, the largest |output|): {suffix: (rel L2, max abs)}.
# In E a flip in act1 moves conv1's outputs, which flips act2's roundings in
# turn: E.bf16 on a 1,024-channel vocoder's own activations reached rel L2
# 1.08e-4 (H100 80GB HBM3, 700 W; tests/test_torch_kernels.py), hence 3e-4.
# Every other instance sees the same operands on both sides and is held at
# ATOL / RTOL.
STAT_TOL = {"bf16": (3e-4, 1e-2), "int8": (1e-3, 5e-2)}
# Kernel B's GEMM route at bf16 dots keeps the tensor cores' own sums (they
# round toward zero, csrc/conv1d_same.cu): on random inputs within ATOL /
# RTOL of its plain version, but at the vocoder's own activations (|y| up
# to 41, K Cin up to 8,448) up to 3.8e-4 apart, on float32 and bf16 maps
# alike (H100 80GB HBM3, 700 W, PR 16). So a replay (``replayed``) holds
# it as D and E at bf16 dots.
REPLAY_STAT = ("conv1d_same.bf16",)


def stat_tol(kernel: str, key=None, replay: bool = False):
    base, sfx, _ = split_name(kernel)
    if sfx and base in ("act_conv1d", "amp_unit"):
        return STAT_TOL[sfx]
    if replay and kernel.partition("@")[0] in REPLAY_STAT and key is not None \
            and key[1] >= NARROW_COUT:  # the GEMM route
        return STAT_TOL[sfx]
    return None


# An instance on bf16 maps rounds its f32 result once, as its plain version
# rounds its own: where the two f32 results lie on either side of a bf16
# rounding boundary, the outputs come out one bf16 step (8 significant bits)
# apart. That is allowed on at most this share of the elements, on top of
# the instance's tolerance, which holds for the rest. An instance held in
# relative L2 (``STAT_TOL``: D and E at bf16 dots) differs from its plain
# version by up to that share before the rounding, and a difference r of
# an element straddles a boundary with a chance of about r / 2^-8: its
# share is the larger of this and 2^8 x its rel L2 tolerance (E.bf16 on bf16
# maps: 1.24% at C = 192, T = 4,001; H100 80GB HBM3, 700 W)
BF16_FLIP_SHARE = 0.01


def bf16_step(v):
    """The bf16 step at |v| (a float64 tensor): 2^(floor(log2 |v|) - 7)."""
    import torch
    a = v.abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(
        torch.where(a > 0, a, torch.ones_like(a)))) - 7), torch.zeros_like(a))


def _compare(name: str, key, got, want, quiet: bool = False,
             replay: bool = False) -> tuple[float, float]:
    """(max abs, max rel) of ``got`` against ``want``; raises beyond the
    instance's tolerance (on bf16 maps: one bf16 step more on at most
    ``BF16_FLIP_SHARE`` of the elements)."""
    import torch
    if got.dtype != want.dtype:
        raise AssertionError(f"{name} at {key}: dtype {got.dtype}, its plain "
                             f"version {want.dtype}")
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / want.abs().clamp(min=1e-12)).max())
    flips = ""
    tol = stat_tol(name, tuple(got.shape), replay)
    if split_name(name)[2]:
        one = (diff > 0) & (diff <= torch.maximum(bf16_step(got),
                                                  bf16_step(want)))
        share = float(one.double().mean())
        limit = BF16_FLIP_SHARE if tol is None else max(BF16_FLIP_SHARE,
                                                        2 ** 8 * tol[0])
        flips = f", one bf16 step apart on {share:.2e} (<= {limit:g})"
        if share > limit:
            raise AssertionError(f"{name} at {key}: one bf16 step apart on "
                                 f"{share:.2e} of the elements")
        got = torch.where(one, want, got)
        diff = (got - want).abs()
    if tol is None:
        ok = bool(torch.all(diff <= ATOL + RTOL * want.abs()))
        what = f"atol={ATOL}, rtol={RTOL}"
        shown = f"max_rel {max_rel:.3e}"
    else:
        rel_l2 = float(diff.norm() / want.norm().clamp(min=1e-30))
        scale = max(1.0, float(want.abs().max()))
        ok = rel_l2 <= tol[0] and float(diff.max()) <= tol[1] * scale
        what = f"rel L2 {tol[0]}, max abs {tol[1]} x {scale:.3g}"
        shown = f"rel L2 {rel_l2:.3e}"
    if not quiet or not ok:
        print(f"  {name} {key}: max_abs {max_abs:.3e} {shown}{flips} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name} at {key} disagrees with its plain version "
                             f"beyond {what}")
    return max_abs, max_rel


def _cases(kernel: str, key, randn):
    """(kernel call, plain call, library call or None, unfused A+B chain or
    None, the float32 instance's call) on fresh inputs of one shape key of
    ``kernel`` (an instance name). The library call of a bf16 instance is
    the PyTorch conv on bf16 tensors; int8 has none. The chain runs at the
    instance's dot dtype. On bf16 maps (``@bf16``) x and the residuals are
    bf16, and "the float32 instance" is the same dot dtype's instance on
    the same values in float32 maps (converted before the timing)."""
    import torch
    import torch.nn.functional as F

    from flowhigh_tpu_torch import ops
    from flowhigh_tpu_torch.utils import cudnn_f32

    base, _, bf16_maps = split_name(kernel)
    dt = dot_dtype_of(kernel)
    mt = torch.bfloat16 if bf16_maps else torch.float32
    lib_dt = ({torch.bfloat16: torch.bfloat16} if bf16_maps else
              {torch.float32: torch.float32,
               torch.bfloat16: torch.bfloat16}).get(dt)

    def maps(*shape, scale=1.0):
        return randn(*shape, scale=scale).to(mt)

    def wide(*vs):  # the maps in float32, for the float32-map instance
        return tuple(v.float() for v in vs)

    def act_params(c):
        return randn(c, scale=0.3), randn(c, scale=0.3)

    if base == "snake_aa":
        c, t = key
        x = maps(1, c, t)
        a, b = act_params(c)
        (xf,) = wide(x)
        return (lambda: ops.snake_activation1d(x, a, b, True),
                lambda: ops.snake_activation1d_plain(x, a, b, True), None, None,
                lambda: ops.snake_activation1d(xf, a, b, True))
    if base in ("conv1d_same", "act_conv1d"):
        cin, cout, t, k, d, n_res, scale = key
        x = maps(1, cin, t)
        w = randn(cout, cin, k, scale=(cin * k) ** -0.5)
        b = randn(cout, scale=0.1)
        res = tuple(maps(1, cout, t) for _ in range(n_res))
        xf, resf = wide(x)[0], wide(*res)
        kw = dict(dilation=d, residuals=res, out_scale=scale)
        kwd = dict(kw, dot_dtype=dt)
        # the float32 instance (on float32 maps: at the same dot dtype)
        kwf = (dict(kwd, residuals=resf) if bf16_maps else kw)
        if base == "act_conv1d":
            a, be = act_params(cin)
            return (lambda: ops.act_conv1d(x, a, be, True, w, b, **kwd),
                    lambda: ops.act_conv1d_plain(x, a, be, True, w, b, **kwd),
                    None,
                    lambda: ops.conv1d(ops.snake_activation1d(x, a, be, True),
                                       w, b, **kwd),
                    lambda: ops.act_conv1d(xf, a, be, True, w, b, **kwf))
        lib = None
        if lib_dt is not None:
            xl, wl, bl = (v.to(lib_dt) for v in (x, w, b))

            def lib():
                with cudnn_f32():
                    return F.conv1d(xl, wl, bl, padding=d * (k - 1) // 2,
                                    dilation=d)
        return (lambda: ops.conv1d(x, w, b, **kwd),
                lambda: ops.conv1d_plain(x, w, b, **kwd), lib, None,
                lambda: ops.conv1d(xf, w, b, **kwf))
    if base == "amp_unit":
        c, t, k, d, n_extra, scale = key
        x = maps(1, c, t)
        a1, b1 = act_params(c)
        a2, b2 = act_params(c)
        w1 = randn(c, c, k, scale=(c * k) ** -0.5)
        w2 = randn(c, c, k, scale=(c * k) ** -0.5)
        bias1, bias2 = randn(c, scale=0.1), randn(c, scale=0.1)
        ex = tuple(maps(1, c, t) for _ in range(n_extra))
        xf, exf = wide(x)[0], wide(*ex)
        args = (x, a1, b1, a2, b2, True, w1, bias1, w2, bias2)
        kw = dict(dilation=d, extra_residuals=ex, out_scale=scale)
        if bf16_maps:
            argsf = (xf,) + args[1:]
            kwf = dict(kw, extra_residuals=exf, dot_dtype=dt)
        else:
            argsf, kwf = args, kw

        def chain():
            h = ops.conv1d(ops.snake_activation1d(x, a1, b1, True), w1, bias1,
                           dilation=d, dot_dtype=dt)
            return ops.conv1d(ops.snake_activation1d(h, a2, b2, True), w2,
                              bias2, residuals=(x,) + ex, out_scale=scale,
                              dot_dtype=dt)
        return (lambda: ops.amp_unit(*args, **kw, dot_dtype=dt),
                lambda: ops.amp_unit_plain(*args, **kw, dot_dtype=dt), None,
                chain, lambda: ops.amp_unit(*argsf, **kwf))
    cin, cout, t, u, k = key
    x = maps(1, cin, t)
    w = randn(cin, cout, k, scale=(cout * k) ** -0.5)
    b = randn(cout, scale=0.1)
    lib = None
    if lib_dt is not None:  # none computes f32 dots on bf16 maps
        xl, wl, bl = (v.to(lib_dt) for v in (x, w, b))

        def lib():
            with cudnn_f32():
                return F.conv_transpose1d(xl, wl, bl, stride=u,
                                          padding=(k - u) // 2)
    (xf,) = wide(x)
    return (lambda: ops.conv_transpose1d(x, w, b, stride=u, dot_dtype=dt),
            lambda: ops.conv_transpose1d_plain(x, w, b, stride=u,
                                               dot_dtype=dt), lib, None,
            lambda: ops.conv_transpose1d(
                xf, w, b, stride=u,
                dot_dtype=dt if bf16_maps else torch.float32))


def check_kernels(shapes: dict, device, peaks) -> dict:
    """Phase 1: each kernel against its plain version at every shape key of
    ``shapes`` ({kernel: set of keys}); returns {kernel: {key: row}}."""
    import torch

    flops, bw = peaks[:2]
    # drawn where they are used (the maps reach 48 x 480,000 elements), from
    # a seeded generator
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    rows: dict = {}
    for kernel, keys in shapes.items():
        rows[kernel] = {}
        variant = "." in kernel or BF16_MAPS in kernel
        # the instances on bf16 maps: fewer repetitions (phase 1's time)
        reps, reps_other = ((REPS_BF16_MAPS, REPS_BF16_MAPS_OTHER)
                            if BF16_MAPS in kernel else ((REPS, WARMUP),) * 2)
        for key in sorted(keys):
            run, plain, lib, chain, f32 = _cases(kernel, key, randn)
            max_abs, max_rel = _compare(kernel, key, run(), plain())
            byt, dots, other = work(kernel, key)
            row = {"max_abs_err": max_abs, "max_rel_err": max_rel,
                   "bytes": byt, "ops": dots + other,
                   "bytes_ms": byt / bw * 1e3,
                   "ops_ms": (dot_seconds(peaks, kernel, dots, key)
                              + other / flops) * 1e3,
                   "ms": time_ms(run, *reps),
                   "plain_ms": time_ms(plain, *reps_other),
                   "library_ms": (time_ms(lib, *reps_other) if lib is not None
                                  else None),
                   "unfused_chain_ms": (time_ms(chain, *reps_other)
                                        if chain is not None else None)}
            if variant:
                row["f32_ms"] = time_ms(f32, *reps)
            rows[kernel][key] = row
            del run, plain, lib, chain, f32
    return rows


def path_totals(calls: dict, rows: dict) -> dict:
    """Per-clip sums of the phase-1 rows over one path's launches."""
    out = {}
    for kernel, keys in calls.items():
        if not keys:
            continue
        sel = [(n, rows[kernel][key]) for key, n in keys.items()]
        tot = lambda f: sum(n * r[f] for n, r in sel)  # noqa: E731
        opt = lambda f: (None if sel[0][1][f] is None  # noqa: E731
                         else tot(f))
        bytes_ms, ops_ms = tot("bytes_ms"), tot("ops_ms")
        out[kernel] = {
            "launches": sum(n for n, _ in sel),
            "max_abs_err": max(r["max_abs_err"] for _, r in sel),
            "bound_ms": sum(n * max(r["bytes_ms"], r["ops_ms"]) for n, r in sel),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "library_ms": opt("library_ms"),
            "unfused_chain_ms": opt("unfused_chain_ms"),
            "shapes": [{"key": list(key), "launches": n, **rows[kernel][key]}
                       for key, n in keys.items()],
        }
        if "f32_ms" in sel[0][1]:  # a variant: its float32 instance's time
            out[kernel]["f32_ms"] = tot("f32_ms")
    return out


def conv_groups(total: dict) -> dict:
    """Kernel B's per-launch rows of one path (``path_totals``) grouped by
    resblock shape (C, T, K, d), and conv_post by its key: {group: {launches,
    ms, library_ms, bound_ms, max_abs_err}}, each summed over the group's
    launches."""
    out: dict = {}
    for r in total["shapes"]:
        cin, cout, t, k, d = r["key"][:5]
        grp = (cin, t, k, d) if cout >= NARROW_COUT else tuple(r["key"])
        n = r["launches"]
        g = out.setdefault(grp, {"launches": 0, "ms": 0.0, "library_ms": 0.0,
                                 "bound_ms": 0.0, "max_abs_err": 0.0})
        g["launches"] += n
        g["ms"] += n * r["ms"]
        g["library_ms"] += n * (r["library_ms"] or 0.0)
        g["bound_ms"] += n * max(r["bytes_ms"], r["ops_ms"])
        g["max_abs_err"] = max(g["max_abs_err"], r["max_abs_err"])
    return out


def print_conv_rows(kernel: str, total: dict) -> None:
    """Phase 1: kernel B's rows per resblock shape of one path, per clip
    (int8 has no cuDNN call)."""
    lib = total["library_ms"] is not None
    for grp, g in sorted(conv_groups(total).items(),
                         key=lambda kv: (-kv[0][0], kv[0][1:])):
        what = ("(C, T, K, d) " if len(grp) == 4 else "conv_post ") + str(grp)
        cudnn = f"cuDNN {g['library_ms']:.3f}, " if lib else ""
        print(f"  {kernel} {what}: {g['launches']} launches, per clip "
              f"{g['ms']:.3f} ms ({cudnn}bound {g['bound_ms']:.3f}), max "
              f"abs err {g['max_abs_err']:.2e}", flush=True)
    cudnn = f"cuDNN {total['library_ms']:.2f}, " if lib else ""
    print(f"  {kernel}: {total['launches']} launches, per clip "
          f"{total['ms']:.2f} ms ({cudnn}bound {total['bound_ms']:.2f} "
          f"{total['bound_by']})", flush=True)


# --- kernel F ------------------------------------------------------------------

FLASH_H, FLASH_D, FLASH_SCALE = 16, 64, 10.0  # the model's heads, width, qk scale
# (B, N, valid frames of each row): the mask's tail is False
FLASH_SHAPES = ((1, 128, (128,)), (2, 128, (128, 120)), (1, 1000, (950,)),
                (2, 1000, (950, 998)), (1, 4096, (4000,)),
                (2, 4096, (4000, 4094)))


# the softmax's operations per score on the FMA units: scale, maximum,
# subtraction, exponential, sum
SOFTMAX_OPS = 5.0


def flash_work(valids, n: int) -> tuple[float, float, float]:
    """(bytes: q, k, v read, out written, the mask; the two products'
    operations; the softmax's) of one call of kernel F, over the pairs of
    one segment, which is what these masks need."""
    pairs = FLASH_H * sum(v * v + (n - v) * (n - v) for v in valids)
    byt = 16.0 * len(valids) * FLASH_H * n * FLASH_D + len(valids) * n
    return byt, 4.0 * FLASH_D * pairs, SOFTMAX_OPS * pairs


def flash_row(peaks, q, k, v, mask, reps: int = REPS,
              warmup: int = WARMUP) -> dict:
    """Kernel F at one shape (``mask`` [B, N] bool): its bound (bytes and
    operations of ``flash_work``, both products as 3xTF32, the softmax on
    the FMA units; and the products as f32 FMAs) and the times of
    the kernel, its plain version (float32) and SDPA's memory-efficient
    backend with a boolean segment mask (it has no pad keys, so a masked
    row's softmax differs from F's: a yardstick only)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from flowhigh_tpu_torch import ops
    flops, bw = peaks[:2]
    valids = tuple(int(m.sum()) for m in mask)
    byt, dots, other = flash_work(valids, q.shape[2])
    same = (mask[:, None, :, None] == mask[:, None, None, :])

    def lib():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=same,
                                                  scale=FLASH_SCALE)
    return {"bytes": byt, "ops": dots + other, "bytes_ms": byt / bw * 1e3,
            "ops_ms": (dot_seconds(peaks, FLASH, dots) + other / flops) * 1e3,
            "fma_ops_ms": dots / flops * 1e3,
            "ms": time_ms(lambda: ops.flash_attention(q, k, v, mask,
                                                      FLASH_SCALE),
                          reps, warmup),
            "plain_ms": time_ms(lambda: ops.flash_attention_plain(
                q, k, v, mask, FLASH_SCALE), reps, warmup),
            "library_ms": time_ms(lib, reps, warmup)}


def check_flash(peaks, long_frames: int) -> dict:
    """Phase 1, kernel F: against its plain version evaluated in float64
    over every row at ``FLASH_SHAPES`` (in float32 the plain version's own
    rounding of the sharp scores reaches 1e-4 at D = 64: 1.1e-4 at (2, 128)
    on these inputs, on the CPU with the card's order of sums;
    tests/test_torch_flash_plan.py), and at the long-form shape (B = 1, N =
    long_frames, all valid) 256 random query rows per head against an exact
    float64 softmax; times and bound at each (``flash_row``)."""
    import torch

    from flowhigh_tpu_torch import ops
    from flowhigh_tpu_torch.ops.flash_attn import flash_block

    rng = np.random.default_rng(2)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).cuda()

    rows = {}
    for b, n, valids in FLASH_SHAPES + ((1, long_frames, (long_frames,)),):
        q, k, v = (randn(b, FLASH_H, n, FLASH_D) for _ in range(3))
        mask = (torch.arange(n, device="cuda")[None, :]
                < torch.tensor(valids, device="cuda")[:, None])
        got = ops.flash_attention(q, k, v, mask, FLASH_SCALE)
        if n == long_frames:
            sel = torch.from_numpy(np.stack([rng.choice(n, 256, replace=False)
                                             for _ in range(FLASH_H)])).cuda()
            qs = torch.gather(q[0].double(), 1,
                              sel[..., None].expand(-1, -1, FLASH_D))
            s = torch.matmul(qs, k[0].double().transpose(-1, -2)) * FLASH_SCALE
            want = torch.matmul(s.softmax(dim=-1), v[0].double())
            got = torch.gather(got[0].double(), 1,
                               sel[..., None].expand(-1, -1, FLASH_D))
            del s
            reps, warmup = 5, 1
        else:  # the plain version evaluated in float64 (see the docstring)
            want = ops.flash_attention_plain(q.double(), k.double(),
                                             v.double(), mask, FLASH_SCALE)
            reps, warmup = REPS, WARMUP
        d = (got.double() - want).abs()
        err_max, err_mean = float(d.max()), float(d.mean())
        single = flash_block(n) >= n
        ok = (bool(torch.isfinite(got).all())
              and (err_max <= 1e-4 if single
                   else err_max < 5e-3 and err_mean < 1e-4))
        key = (b, n) + tuple(valids)
        print(f"  flash_attn {key}: max_abs {err_max:.3e} mean_abs "
              f"{err_mean:.3e} ({'one block, atol 1e-4' if single else 'several blocks, max 5e-3, mean 1e-4'}"
              f"{', 256 rows per head vs float64' if n == long_frames else ', every row'}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise AssertionError(f"flash_attn at {key} disagrees with its "
                                 "reference")
        del got, want, d
        rows[key] = {"max_abs_err": err_max, "mean_abs_err": err_mean,
                     **flash_row(peaks, q, k, v, mask, reps, warmup)}
        r = rows[key]
        print(f"    {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, SDPA "
              f"{r['library_ms']:.3f}, bound {max(r['bytes_ms'], r['ops_ms']):.3f}"
              f" 3xTF32, {r['fma_ops_ms']:.3f} f32 FMA)", flush=True)
        del q, k, v, mask
    return rows


# --- end to end ----------------------------------------------------------------

def make_sr(config, device: str, seed: int = 0, fuse_act_conv=True,
            conv_dtype=None, **kw):
    """Seeded random weights at ``config``; ``kw`` (e.g. ``ode_method``,
    ``use_torchode``, ``upsampling_method``) override the constructor's
    arguments."""
    from flowhigh_tpu_torch import FlowHighSR
    args = dict(cfm_method="independent_cfm_adaptive", ode_method="euler",
                fuse_act_conv=fuse_act_conv, vocoder_conv_dtype=conv_dtype,
                device=device)
    sr = FlowHighSR(config, **{**args, **kw})
    sr.init_params(seed)
    return sr


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@contextlib.contextmanager
def replayed(records: list):
    """Every kernel wrapper the vocoder calls (``models/bigvgan.py``) also
    runs its plain version on the same inputs, and the two are held
    against each other at the instance's tolerance (``_compare``);
    ``records`` gets one (instance, max abs, max rel) per call. This
    checks every launch of a forward at its own activations, whatever the
    reduced-precision roundings upstream of it did (kernel B's GEMM route
    at bf16 dots held as D and E there: ``REPLAY_STAT``)."""
    import torch

    from flowhigh_tpu_torch import ops
    from flowhigh_tpu_torch.models import bigvgan
    pairs = {"snake_activation1d": ("snake_aa", ops.snake_activation1d_plain),
             "conv1d": ("conv1d_same", ops.conv1d_plain),
             "conv_transpose1d": ("conv_transpose1d",
                                  ops.conv_transpose1d_plain),
             "act_conv1d": ("act_conv1d", ops.act_conv1d_plain),
             "amp_unit": ("amp_unit", ops.amp_unit_plain)}
    saved = {name: getattr(bigvgan, name) for name in pairs}

    def wrap(name):
        kernel, plain = pairs[name]

        def call(*args, **kw):
            got = saved[name](*args, **kw)
            want = plain(*args, **kw)
            inst = kernel + suffix(kw.get("dot_dtype")) + (
                BF16_MAPS if args[0].dtype == torch.bfloat16 else "")
            records.append((inst,) + _compare(inst, tuple(args[0].shape), got,
                                              want, quiet=True, replay=True))
            return got
        return call

    try:
        for name in pairs:
            setattr(bigvgan, name, wrap(name))
        yield records
    finally:
        for name, fn in saved.items():
            setattr(bigvgan, name, fn)


@contextlib.contextmanager
def snake_arguments(largest: list):
    """Every call of kernel A in the vocoder also appends the largest |a u|
    of its input to ``largest``: u = up2(x) by the plain resampler, a the
    snake's alpha (exp'd under logscale). That is the argument of A's sine,
    whose error bound ``csrc/snake.cuh`` states up to 2^15."""
    import torch

    from flowhigh_tpu_torch.models import bigvgan
    saved = bigvgan.snake_activation1d

    def call(x, alpha, beta, logscale=True):
        with torch.no_grad():
            a = torch.exp(alpha) if logscale else alpha
            u = bigvgan.upsample1d(x, 2, 12)
            largest.append(float((u * a[None, :, None]).abs().max()))
        return saved(x, alpha, beta, logscale)

    try:
        bigvgan.snake_activation1d = call
        yield largest
    finally:
        bigvgan.snake_activation1d = saved


def launch_counts() -> dict:
    """{instance: launches} of every kernel instance since the last
    ``ops.reset_launch_counts``."""
    from flowhigh_tpu_torch import ops
    out = {k: fn.launches for k, fn in zip(ALL_KERNELS, ops.KERNELS)}
    for name, (fn, dot_dtype) in zip(VARIANT_NAMES, ops.VARIANTS):
        out[name] = fn.variant_launches[dot_dtype]
    for name, (fn, dot_dtype) in zip(STORAGE_NAMES, ops.STORAGE_VARIANTS):
        out[name] = fn.storage_launches[dot_dtype]
    return out


def run_main_path(sr, audio: np.ndarray, in_sr: int) -> tuple[np.ndarray, dict]:
    """One generate with every launch count zeroed just before and read just
    after."""
    from flowhigh_tpu_torch import ops
    ops.reset_launch_counts()
    out = sr.generate(audio, in_sr, timestep=1)
    return out, launch_counts()


def clip_ms_of(sr, audio: np.ndarray, reps: int = 5) -> list:
    """Host ms of ``reps`` generates, each ending in a synchronize."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sr.generate(audio, IN_SR, timestep=1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def check_launches(what: str, counts: dict, calls: dict,
                   flash: int = 0) -> None:
    expected = {k: sum(calls.get(k, {}).values())
                for k in KERNEL_NAMES + VARIANT_NAMES + STORAGE_NAMES}
    expected[FLASH] = flash
    print(f"{what}: launches {counts} (expected {expected})", flush=True)
    if counts != expected:
        raise AssertionError(f"{what}: launches {counts}, expected {expected}")


def serving_phase(sr) -> dict:
    """ServingPipeline over 12 x 10 s clips (float32 and int16 wire) and
    generate_batch on 4 mixed-rate clips against per-clip generate."""
    from flowhigh_tpu_torch.profiling import clip_signal
    from flowhigh_tpu_torch.serving import ServingPipeline

    n_clips = 12
    rng = np.random.default_rng(1)
    base = clip_signal(SECONDS, IN_SR)
    clips = [(base * (0.6 + 0.4 * rng.random())).astype(np.float32)
             for _ in range(n_clips)]
    res: dict = {}
    for wire in ("float32", "int16"):
        with ServingPipeline(sr, max_in_flight=8, wire=wire) as srv:
            srv.warmup(IN_SR, SECONDS)
            t0 = time.perf_counter()
            outs = srv.generate_many(clips, IN_SR)
            wall = time.perf_counter() - t0
            pinned = srv.submit(clips[0], IN_SR, seed=0).result()
            errors = list(srv._pipe.stage_errors)
        if errors or any(o.shape != (1, int(SECONDS * 48000))
                         or not np.isfinite(o).all() for o in outs):
            raise AssertionError(f"serving ({wire}) failed: {errors}")
        direct = sr.generate(clips[0], IN_SR, timestep=1, seed=0)
        pinned_diff = float(np.abs(pinned - direct).max())
        limit = 0.0 if wire == "float32" else 0.5 / 32767 + 1e-7
        res[wire] = {"clips": n_clips, "wall_s": wall,
                     "rtf": n_clips * SECONDS / wall,
                     "pinned_seed_vs_generate": pinned_diff}
        print(f"serving ({wire} wire): {n_clips} x {SECONDS:g} s clips in "
              f"{wall:.3f} s, sustained RTF {n_clips * SECONDS / wall:.1f}; "
              f"pinned seed vs generate {pinned_diff:.3e}", flush=True)
        if not pinned_diff <= limit:
            raise AssertionError(f"serving ({wire}) differs from generate")

    srs = [16000, 8000, 16000, 8000]
    mixed = [clip_signal(SECONDS, r) * np.float32(0.5 + 0.1 * i)
             for i, r in enumerate(srs)]
    batch = sr.generate_batch(mixed, srs, timestep=1)
    single = [sr.generate(a, r, timestep=1) for a, r in zip(mixed, srs)]
    batch_diff = max(float(np.abs(b - s).max()) for b, s in zip(batch, single))
    res["generate_batch_vs_generate"] = batch_diff
    print(f"serving: generate_batch (4 clips, 16 and 8 kHz) vs per-clip "
          f"generate max abs diff {batch_diff:.3e}", flush=True)
    if not batch_diff <= 1e-4:
        raise AssertionError(f"generate_batch differs: {batch_diff}")
    return res


def stage_diffs(sr_gpu, sr_cpu, audio: np.ndarray) -> dict:
    """Max abs card-vs-CPU differences of the pieces of one clip: the
    log-mel with its STFT in float32 and in float64 (the encode's), and the
    vocoder alone on one mel (the default path's kernels against the plain
    versions)."""
    import torch

    from flowhigh_tpu_torch.dsp import (apply_mel, log_compress,
                                        mel_filterbank, resample_poly,
                                        stft_magnitude)
    from flowhigh_tpu_torch.models import mel_encode

    def log_mel_f32(x):
        mag = stft_magnitude(x, 2048, 480, 2048, center=False,
                             pad_mode="reflect", eps=1e-9)
        return log_compress(apply_mel(mag, mel_filterbank()))

    x = resample_poly(torch.from_numpy(audio)[None], 48000, IN_SR)
    with torch.inference_mode():
        out = {}
        for name, fn in (("log_mel_f32_stft", log_mel_f32),
                         ("log_mel_f64_stft", mel_encode)):
            out[name] = float((fn(x.cuda()).cpu() - fn(x)).abs().max())
        mel = mel_encode(x)
        out["vocoder_same_mel"] = float(
            (sr_gpu.vocoder(mel.cuda()).cpu() - sr_cpu.vocoder(mel)).abs().max())
    return out


def longform_phase(config, dense_out: np.ndarray, audio10: np.ndarray) -> dict:
    """Phase L (see the module docstring); ``dense_out`` is phase 2's
    default-path output of ``audio10``."""
    import torch

    from flowhigh_tpu_torch import (StreamingSR, boundary_lsd,
                                    log_spectral_distance, ops)
    from flowhigh_tpu_torch.dsp import resample_poly
    from flowhigh_tpu_torch.models import mel_encode
    from flowhigh_tpu_torch.profiling import clip_signal, device_profile

    cfg = config.replace(model=dataclasses.replace(config.model,
                                                   attn_flash=True))
    sr = make_sr(cfg, "cuda")  # phase 2's seed: the same weights
    audio = clip_signal(LONG_SECONDS, IN_SR)
    n48 = int(LONG_SECONDS * 48000)
    calls = longform_calls(cfg.vocoder, n48 // cfg.mel.hop_length)

    def run():
        return sr.generate_longform(audio, IN_SR, timestep=1,
                                    vocoder_chunk_frames=CHUNK,
                                    vocoder_overlap_frames=OVERLAP)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase L: {LONG_SECONDS:g} s clip single-pass: out {out.shape} "
          f"finite={bool(np.isfinite(out).all())}, first run {first_s:.2f} s, "
          f"peak device memory {peak / 2 ** 30:.2f} GiB", flush=True)
    if out.shape != (1, n48) or not np.isfinite(out).all():
        raise AssertionError(f"long-form: bad output {out.shape}")
    # one euler step: one vector-field pass, one F launch per layer
    check_launches("phase L: long-form path", counts, calls,
                   flash=cfg.model.depth)
    if min(counts[k] for k in ALL_KERNELS) == 0:
        raise AssertionError(f"a kernel did not run on the long-form path: "
                             f"{counts}")
    del out
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3)
    clip_ms = float(np.median(times))
    wall_prof, groups, kernels = device_profile(run, 1)
    f_ms = groups.get("kernel F: flash_attn", 0.0)
    voc_ms = sum(ms for g, ms in groups.items()
                 if g.startswith("kernel ") and not g.startswith("kernel F"))
    busy = sum(groups.values())
    print(f"phase L: {clip_ms:.1f} ms per {LONG_SECONDS:g} s clip (median of "
          f"3: {[round(t, 1) for t in times]}), RTF "
          f"{LONG_SECONDS * 1e3 / clip_ms:.1f}; traced: F {f_ms:.1f} ms, "
          f"vocoder kernels A-E {voc_ms:.1f} ms, device busy {busy:.1f} of "
          f"{wall_prof:.1f} ms wall", flush=True)

    # checks on 10 s
    whole = sr.generate(audio10, IN_SR, timestep=1)
    lf = sr.generate_longform(audio10, IN_SR, timestep=1,
                              vocoder_chunk_frames=250,
                              vocoder_overlap_frames=OVERLAP)
    d_lf = float(np.abs(lf - whole).max()) if lf.shape == whole.shape \
        else float("inf")
    x20 = resample_poly(torch.from_numpy(clip_signal(20.0, IN_SR))[None]
                        .cuda(), 48000, IN_SR)
    with torch.inference_mode():
        mel = mel_encode(x20)
        d_voc = float((sr.vocode_chunked(mel) - sr.vocoder(mel)).abs().max())
    d_fd = float(np.abs(whole - dense_out).max())
    print(f"phase L: 10 s: generate_longform (windows of 250 frames) vs "
          f"generate {d_lf:.3e} (<= 2e-4); vocode_chunked vs whole vocoder "
          f"on {mel.shape[1]} frames {d_voc:.3e} (<= 1e-5); flash vs dense "
          f"generate {d_fd:.3e} (<= 1e-3)", flush=True)
    if not (d_lf <= 2e-4 and d_voc <= 1e-5 and d_fd <= 1e-3):
        raise AssertionError(f"long-form 10 s checks failed: {d_lf}, "
                             f"{d_voc}, {d_fd}")

    # StreamingSR on 60 s against the single pass; wall time the median of
    # STREAM_REPS runs of each wire (one run spread beyond 4%)
    audio60 = clip_signal(60.0, IN_SR)
    single = sr.generate_longform(audio60, IN_SR, timestep=1)
    streams = {}
    for wire in ("float32", "int16"):
        st = StreamingSR(sr, chunk_seconds=10.0, overlap_seconds=1.0,
                         wire=wire)
        if wire == "float32":
            st.generate(audio60, IN_SR)  # warm-up: the 10 s chunk shapes
        walls = []
        for _ in range(STREAM_REPS):
            t0 = time.perf_counter()
            got = st.generate(audio60, IN_SR)
            walls.append(time.perf_counter() - t0)
        streams[wire] = (got, float(np.median(walls)))
        if got.shape != single.shape or not np.isfinite(got).all():
            raise AssertionError(f"StreamingSR ({wire}): bad output "
                                 f"{got.shape}")
    (f32, wall32), (i16, wall16) = streams["float32"], streams["int16"]
    d_wire = float(np.abs(i16 - f32).max())
    hop_in = int(10.0 * IN_SR) - int(1.0 * IN_SR)
    n_chunks = 1 + -(-(len(audio60) - int(10.0 * IN_SR)) // hop_in)
    boundaries = [c * hop_in * 3 for c in range(1, n_chunks)]
    seam = boundary_lsd(single, f32, boundaries, window=24000)
    overall = float(log_spectral_distance(single, f32)[0])
    print(f"phase L: StreamingSR 60 s ({n_chunks} chunks): RTF "
          f"{60.0 / wall32:.1f} (float32 wire), {60.0 / wall16:.1f} (int16); "
          f"int16 vs float32 {d_wire:.3e} (<= 1e-4); seam LSD {seam:.4f} dB "
          f"vs overall {overall:.4f} dB (bound {max(2.0, 2.5 * overall):.4f})",
          flush=True)
    if not (d_wire <= 1e-4 and seam < max(2.0, 2.5 * overall)
            and np.isfinite(seam) and np.isfinite(overall)):
        raise AssertionError(f"StreamingSR checks failed: {d_wire}, {seam}, "
                             f"{overall}")
    return {"launches": counts, "clip_ms": clip_ms,
            "clip_ms_all": times, "rtf": LONG_SECONDS * 1e3 / clip_ms,
            "first_run_s": first_s, "peak_bytes": peak,
            "traced": {"wall_ms": wall_prof, "device_busy_ms": busy,
                       "flash_ms": f_ms, "vocoder_kernels_ms": voc_ms,
                       "groups_ms": groups, "kernels": kernels[:40]},
            "longform_vs_generate_10s": d_lf,
            "vocode_chunked_vs_whole_2000_frames": d_voc,
            "flash_vs_dense_generate_10s": d_fd,
            "streaming": {"chunks": n_chunks, "rtf_float32": 60.0 / wall32,
                          "rtf_int16": 60.0 / wall16,
                          "int16_vs_float32": d_wire, "seam_lsd_db": seam,
                          "overall_lsd_db": overall}}


REDUCED = ("bfloat16", "int8")  # the vocoder_conv_dtype values of phase P
# phase P: rel L2 of the 10 s output from the float32 one. bf16: the JAX
# package's int8 generator bound (tests/test_packed.py:523, a 64-channel,
# two-stage vocoder). int8 at full width with random weights: the
# quantisation itself moves the output ~0.18 (phase 3 measures the CPU's
# plain int8 path at 1 s, which the card must match)
FROM_F32 = {"float32": 0.1, "bfloat16": 0.1, "int8": 0.25}
# relative input nudge of phase 3's rounding floor: the order of the card's
# float32 difference from the CPU (phase 3 prints both)
NUDGE = 2.0 ** -16


def reduced_phase(config, frames: int, f32_out: np.ndarray,
                  audio: np.ndarray, f32_1s: tuple) -> dict:
    """Phase P and the reduced-precision part of phase 3 (see the module
    docstring); ``f32_out`` is phase 2's default-path output of ``audio``,
    ``f32_1s`` phase 3's float32 outputs of the 1 s clip (card, CPU)."""
    import torch

    from flowhigh_tpu_torch import log_spectral_distance
    from flowhigh_tpu_torch.profiling import clip_signal

    res: dict = {}
    short = clip_signal(1.0, IN_SR)
    for name in REDUCED:
        dt = getattr(torch, name)
        r: dict = {}
        for fuse, what in ((True, "fused"), (False, "unfused")):
            calls = main_path_calls(config.vocoder, frames, fuse, dt)
            sr = make_sr(config, "cuda", fuse_act_conv=fuse, conv_dtype=dt)
            out, counts = run_main_path(sr, audio, IN_SR)
            torch.cuda.synchronize()
            if out.shape != (1, int(SECONDS * 48000)) or \
                    not np.isfinite(out).all():
                raise AssertionError(f"phase P {name} {what}: bad output "
                                     f"{out.shape}")
            check_launches(f"phase P: {name} {what} path", counts, calls)
            mine = [k for k in VARIANT_NAMES if sum(calls.get(k, {}).values())]
            if not mine or min(counts[k] for k in mine) == 0:
                raise AssertionError(f"phase P {name} {what}: a variant of "
                                     f"the path did not run: {counts}")
            times = clip_ms_of(sr, audio)
            clip_ms = float(np.median(times))
            rel = rel_l2(out, f32_out)
            lsd = float(log_spectral_distance(f32_out, out)[0])
            print(f"phase P: {name} {what} path out {out.shape} finite, "
                  f"{clip_ms:.2f} ms per 10 s clip (median of 5: "
                  f"{[round(t, 2) for t in times]}), RTF "
                  f"{SECONDS * 1e3 / clip_ms:.1f}; vs the float32 default "
                  f"output: rel L2 {rel:.4e} (<= {FROM_F32[name]}), "
                  f"waveform LSD {lsd:.4f} dB", flush=True)
            if not rel <= FROM_F32[name]:
                raise AssertionError(f"phase P {name} {what}: rel L2 {rel} "
                                     "from float32")
            r[what] = {"launches": counts, "clip_ms": clip_ms,
                       "clip_ms_all": times,
                       "rtf": SECONDS * 1e3 / clip_ms,
                       "rel_l2_vs_f32": rel, "lsd_db_vs_f32": lsd}
            if fuse is not True:
                del sr
                continue

            # phase 3 at this dtype: 1 s, card vs CPU, every launch of the
            # card's run held against its plain version on its own inputs
            records: list = []
            with replayed(records):
                out_gpu = sr.generate(short, IN_SR, timestep=1)
            del sr
            worst: dict = {}
            for inst, max_abs, _ in records:
                n, m = worst.get(inst, (0, 0.0))
                worst[inst] = (n + 1, max(m, max_abs))
            print(f"phase 3: {name}: {len(records)} launches of the card's "
                  f"1 s run each within tolerance of its plain version on "
                  f"its own inputs: {worst}", flush=True)
            sr_cpu = make_sr(config, "cpu", conv_dtype=dt)
            out_cpu = sr_cpu.generate(short, IN_SR, timestep=1)
            floor = max(rel_l2(sr_cpu.generate(
                (short * np.float32(1 + s)).astype(np.float32), IN_SR,
                timestep=1), out_cpu) for s in (NUDGE, -NUDGE))
            del sr_cpu
            rel_cpu = rel_l2(out_gpu, out_cpu)
            lsd_cpu = float(log_spectral_distance(out_cpu, out_gpu)[0])
            bound = max(1e-2, 2 * floor)
            # the reduction's own size: the card's against the CPU's
            own = (rel_l2(out_gpu, f32_1s[0]), rel_l2(out_cpu, f32_1s[1]))
            print(f"phase 3: {name}: 1 s clip against float32: card "
                  f"{own[0]:.4e}, CPU {own[1]:.4e} (the card within 1.5x "
                  f"of the CPU)", flush=True)
            if not own[0] <= 1.5 * own[1]:
                raise AssertionError(f"phase 3 {name}: the card's reduction "
                                     f"{own[0]} exceeds the CPU's {own[1]}")
            print(f"phase 3: {name}: 1 s clip card vs CPU rel L2 "
                  f"{rel_cpu:.4e}, LSD {lsd_cpu:.4f} dB; the CPU against "
                  f"itself with the input nudged by +-2^-16: rel L2 "
                  f"{floor:.4e}; bound max(1e-2, 2 x that) = {bound:.4e}",
                  flush=True)
            if out_gpu.shape != out_cpu.shape or not rel_cpu <= bound:
                raise AssertionError(f"phase 3 {name}: card and CPU disagree "
                                     f"beyond the rounding floor: {rel_cpu}")
            r["card_vs_cpu_1s"] = {"rel_l2": rel_cpu, "lsd_db": lsd_cpu,
                                   "vs_f32_card_cpu": own,
                                   "nudge_floor_rel_l2": floor,
                                   "bound": bound,
                                   "replayed": {k: list(v) for k, v in
                                                worst.items()}}
        res[name] = r
    return res


# the vocoder_conv_dtype values of phase P's bf16-map runs
STORAGE_DOTS = ("float32", "bfloat16", "int8")


def storage_phase(config, frames: int, f32_out: np.ndarray,
                  audio: np.ndarray, f32_1s: tuple) -> dict:
    """Phase P on bf16 feature maps (``vocoder_storage_dtype=bfloat16``) at
    each dot dtype, fused and unfused, on phase 2's 10 s clip and weights:
    launch counts against ``main_path_calls`` (every instance on bf16 maps
    of the path launched), output shape and finiteness, ms per clip
    (median of 5), rel L2 (``FROM_F32`` of the dot dtype) and waveform LSD
    against phase 2's float32 output; on the 1 s clip every launch of the
    card's run held against its plain version on its own inputs
    (``replayed``: one bf16 step more on at most ``BF16_FLIP_SHARE`` of a
    launch's outputs on bf16 maps), and, fused, the card against the CPU
    under phase 3's rule for reduced precision."""
    import torch

    from flowhigh_tpu_torch import log_spectral_distance
    from flowhigh_tpu_torch.profiling import clip_signal

    res: dict = {}
    short = clip_signal(1.0, IN_SR)
    bf = torch.bfloat16
    for name in STORAGE_DOTS:
        dt = None if name == "float32" else getattr(torch, name)
        r: dict = {}
        for fuse, what in ((True, "fused"), (False, "unfused")):
            tag = f"phase P: bf16 maps, {name} dots, {what} path"
            calls = main_path_calls(config.vocoder, frames, fuse, dt, bf)
            sr = make_sr(config, "cuda", fuse_act_conv=fuse, conv_dtype=dt,
                         vocoder_storage_dtype=bf)
            out, counts = run_main_path(sr, audio, IN_SR)
            torch.cuda.synchronize()
            if out.shape != (1, int(SECONDS * 48000)) or \
                    not np.isfinite(out).all():
                raise AssertionError(f"{tag}: bad output {out.shape}")
            check_launches(tag, counts, calls)
            mine = [k for k in STORAGE_NAMES if sum(calls.get(k, {}).values())]
            if not mine or min(counts[k] for k in mine) == 0:
                raise AssertionError(f"{tag}: an instance on bf16 maps did "
                                     f"not run: {counts}")
            times = clip_ms_of(sr, audio)
            clip_ms = float(np.median(times))
            rel = rel_l2(out, f32_out)
            lsd = float(log_spectral_distance(f32_out, out)[0])
            print(f"{tag}: out {out.shape} finite, {clip_ms:.2f} ms per 10 s "
                  f"clip (median of 5: {[round(t, 2) for t in times]}), RTF "
                  f"{SECONDS * 1e3 / clip_ms:.1f}; vs the float32 default "
                  f"output: rel L2 {rel:.4e} (<= {FROM_F32[name]}), waveform "
                  f"LSD {lsd:.4f} dB", flush=True)
            if not rel <= FROM_F32[name]:
                raise AssertionError(f"{tag}: rel L2 {rel} from float32")
            records: list = []
            with replayed(records):
                out_gpu = sr.generate(short, IN_SR, timestep=1)
            del sr
            worst: dict = {}
            for inst, max_abs, _ in records:
                n, m = worst.get(inst, (0, 0.0))
                worst[inst] = (n + 1, max(m, max_abs))
            int8 = [v[1] for k, v in worst.items() if ".int8" in k]
            print(f"{tag}: {len(records)} launches of the card's 1 s run each "
                  f"within tolerance of its plain version on its own inputs: "
                  f"{worst}", flush=True)
            if int8 and max(int8) != 0.0:  # the int8 instances: bit-equal
                raise AssertionError(f"{tag}: an int8 instance differs from "
                                     f"its plain version: {worst}")
            r[what] = {"launches": counts, "clip_ms": clip_ms,
                       "clip_ms_all": times, "rtf": SECONDS * 1e3 / clip_ms,
                       "rel_l2_vs_f32": rel, "lsd_db_vs_f32": lsd,
                       "replayed": {k: list(v) for k, v in worst.items()}}
            if fuse is not True:
                continue
            sr_cpu = make_sr(config, "cpu", conv_dtype=dt,
                             vocoder_storage_dtype=bf)
            out_cpu = sr_cpu.generate(short, IN_SR, timestep=1)
            floor = max(rel_l2(sr_cpu.generate(
                (short * np.float32(1 + s)).astype(np.float32), IN_SR,
                timestep=1), out_cpu) for s in (NUDGE, -NUDGE))
            del sr_cpu
            rel_cpu = rel_l2(out_gpu, out_cpu)
            lsd_cpu = float(log_spectral_distance(out_cpu, out_gpu)[0])
            bound = max(1e-2, 2 * floor)
            own = (rel_l2(out_gpu, f32_1s[0]), rel_l2(out_cpu, f32_1s[1]))
            print(f"{tag}: 1 s clip against float32: card {own[0]:.4e}, CPU "
                  f"{own[1]:.4e} (the card within 1.5x of the CPU); card vs "
                  f"CPU rel L2 {rel_cpu:.4e}, LSD {lsd_cpu:.4f} dB; the CPU "
                  f"against itself with the input nudged by +-2^-16: rel L2 "
                  f"{floor:.4e}; bound max(1e-2, 2 x that) = {bound:.4e}",
                  flush=True)
            if not own[0] <= 1.5 * own[1]:
                raise AssertionError(f"{tag}: the card's reduction {own[0]} "
                                     f"exceeds the CPU's {own[1]}")
            if out_gpu.shape != out_cpu.shape or not rel_cpu <= bound:
                raise AssertionError(f"{tag}: card and CPU disagree beyond "
                                     f"the rounding floor: {rel_cpu}")
            r["card_vs_cpu_1s"] = {"rel_l2": rel_cpu, "lsd_db": lsd_cpu,
                                   "vs_f32_card_cpu": own,
                                   "nudge_floor_rel_l2": floor,
                                   "bound": bound}
        res[name] = r
    return res


# --- phase X: the vocoder's compute dtype ---------------------------------------

# the conv_dtype values of phase X's bf16-compute runs
COMPUTE_DOTS = ("float32", "bfloat16", "int8")
MEL_1S = 100  # mel frames of 1 s at 48 kHz, hop 480


def vocoder_mel(sr, audio: np.ndarray):
    """The mel that ``sr.generate(audio)`` hands its vocoder (a forward
    pre-hook's copy), on the card."""
    seen = []
    hook = sr.vocoder.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].clone()))
    try:
        sr.generate(audio, IN_SR, timestep=1)
    finally:
        hook.remove()
    return seen[0]


def compute_phase(config, mel10) -> dict:
    """Phase X: ``MelVoco(dtype=torch.bfloat16)`` (the generator's compute
    dtype, ``BigVGAN(dtype=)``), fused, at each ``conv_dtype`` of
    ``COMPUTE_DOTS``, with phase 2's vocoder weights (``MelVoco
    .init_vocoder_params(1)``, what ``make_sr``'s seed 0 gives the
    vocoder) on ``mel10``, the mel phase 2's 10 s clip hands its vocoder:
    launch counts of one ``decode`` against ``main_path_calls`` (kernel C
    on bf16 maps 5 a clip), output shape and finiteness, ms per clip
    (median of 5) beside the float32-compute vocoder and the bf16-map
    vocoder (``storage_dtype``) at the same dot dtype, timed in turns, rel
    L2 (``FROM_F32`` of the dot dtype) and waveform LSD against the
    float32 vocoder's output of the same mel; on its first second every
    launch of the card's run held against its plain version on its own
    inputs (``replayed``), and the card against the CPU under phase 3's
    rule for reduced precision (the mel nudged by +-2^-16)."""
    import torch

    from flowhigh_tpu_torch import log_spectral_distance, ops
    from flowhigh_tpu_torch.models import MelVoco

    bf = torch.bfloat16
    frames = mel10.shape[1]
    mel1 = mel10[:, :MEL_1S]

    state = None

    def melvoco(device, **kw):
        nonlocal state
        m = MelVoco(config.mel, config.vocoder, fuse_act_conv=True,
                    device=device, **kw)
        if state is None:  # seeded once, then copied
            m.init_vocoder_params(1)
            state = m.vocoder.state_dict()
        else:
            m.vocoder.load_state_dict(state)
        return m

    def decode_np(m, mel):
        return m.decode(mel.to(m.device)).cpu().numpy()

    def timed(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.decode(mel10)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    ref = melvoco("cuda")
    ref10, ref1 = decode_np(ref, mel10), decode_np(ref, mel1)
    del ref
    ref1_cpu = decode_np(melvoco("cpu"), mel1)
    res: dict = {"frames": frames}
    for name in COMPUTE_DOTS:
        dt = None if name == "float32" else getattr(torch, name)
        tag = f"phase X: bf16 compute, {name} dots"
        calls = main_path_calls(config.vocoder, frames, True, dt, None, bf)
        m = melvoco("cuda", dtype=bf, conv_dtype=dt)
        decode_np(m, mel1)  # builds the rounded weights and their layouts
        ops.reset_launch_counts()
        out = m.decode(mel10)
        counts = launch_counts()
        out = out.cpu().numpy()
        if out.shape != (1, frames * config.mel.hop_length) or \
                not np.isfinite(out).all():
            raise AssertionError(f"{tag}: bad output {out.shape}")
        check_launches(tag, counts, calls)
        convt = "conv_transpose1d" + (".bf16" if name == "bfloat16"
                                      else "") + BF16_MAPS
        if counts[convt] != 5:
            raise AssertionError(f"{tag}: {convt} launched "
                                 f"{counts[convt]} times, not 5")
        # the same dot dtype at float32 compute (f32 maps) and on bf16 maps
        others = {"float32": melvoco("cuda", conv_dtype=dt),
                  "bf16_maps": melvoco("cuda", conv_dtype=dt,
                                       storage_dtype=bf)}
        times: dict = {"bf16_compute": [], **{k: [] for k in others}}
        for v in others.values():
            decode_np(v, mel1)
        for _ in range(5):  # in turns
            times["bf16_compute"].append(timed(m))
            for k, v in others.items():
                times[k].append(timed(v))
        del others
        ms = {k: float(np.median(v)) for k, v in times.items()}
        rel = rel_l2(out, ref10)
        lsd = float(log_spectral_distance(ref10, out)[0])
        print(f"{tag}: out {out.shape} finite, C on bf16 maps {convt} "
              f"{counts[convt]} launches; {ms['bf16_compute']:.2f} ms per "
              f"10 s clip (median of 5: "
              f"{[round(t, 2) for t in times['bf16_compute']]}; float32 "
              f"compute {ms['float32']:.2f}, bf16 maps {ms['bf16_maps']:.2f}"
              f" at the same dots, in turns); vs the float32 vocoder: rel L2"
              f" {rel:.4e} (<= {FROM_F32[name]}), waveform LSD {lsd:.4f} dB",
              flush=True)
        if not rel <= FROM_F32[name]:
            raise AssertionError(f"{tag}: rel L2 {rel} from float32")
        records: list = []
        with replayed(records):
            out1 = decode_np(m, mel1)
        del m
        worst: dict = {}
        for inst, max_abs, _ in records:
            n, mx = worst.get(inst, (0, 0.0))
            worst[inst] = (n + 1, max(mx, max_abs))
        int8 = [v[1] for k, v in worst.items() if ".int8" in k]
        print(f"{tag}: {len(records)} launches of the card's 1 s run each "
              f"within tolerance of its plain version on its own inputs: "
              f"{worst}", flush=True)
        if int8 and max(int8) != 0.0:  # the int8 instances: bit-equal
            raise AssertionError(f"{tag}: an int8 instance differs from its "
                                 f"plain version: {worst}")
        m_cpu = melvoco("cpu", dtype=bf, conv_dtype=dt)
        out1_cpu = decode_np(m_cpu, mel1)
        floor = max(rel_l2(decode_np(m_cpu, mel1 * (1 + s)), out1_cpu)
                    for s in (NUDGE, -NUDGE))
        del m_cpu
        rel_cpu = rel_l2(out1, out1_cpu)
        lsd_cpu = float(log_spectral_distance(out1_cpu, out1)[0])
        bound = max(1e-2, 2 * floor)
        own = (rel_l2(out1, ref1), rel_l2(out1_cpu, ref1_cpu))
        print(f"{tag}: 1 s against float32: card {own[0]:.4e}, CPU "
              f"{own[1]:.4e} (the card within 1.5x of the CPU); card vs CPU "
              f"rel L2 {rel_cpu:.4e}, LSD {lsd_cpu:.4f} dB; the CPU against "
              f"itself with the mel nudged by +-2^-16: rel L2 {floor:.4e}; "
              f"bound max(1e-2, 2 x that) = {bound:.4e}", flush=True)
        if not own[0] <= 1.5 * own[1]:
            raise AssertionError(f"{tag}: the card's reduction {own[0]} "
                                 f"exceeds the CPU's {own[1]}")
        if out1.shape != out1_cpu.shape or not rel_cpu <= bound:
            raise AssertionError(f"{tag}: card and CPU disagree beyond the "
                                 f"rounding floor: {rel_cpu}")
        res[name] = {"launches": counts, "clip_ms": ms["bf16_compute"],
                     "clip_ms_all": times["bf16_compute"],
                     "clip_ms_float32_compute": ms["float32"],
                     "clip_ms_bf16_maps": ms["bf16_maps"],
                     "times_all": times, "rel_l2_vs_f32": rel,
                     "lsd_db_vs_f32": lsd,
                     "replayed": {k: list(v) for k, v in worst.items()},
                     "card_vs_cpu_1s": {"rel_l2": rel_cpu, "lsd_db": lsd_cpu,
                                        "vs_f32_card_cpu": own,
                                        "nudge_floor_rel_l2": floor,
                                        "bound": bound}}
    return res


# --- phase S: the rest of the inference surface ---------------------------------

# the adaptive generates of S1 (name -> constructor arguments); the
# tolerances are the constructor's defaults, atol = rtol = 1e-5
ADAPTIVE = {"dopri5": dict(ode_method="adaptive"),
            "tsit5": dict(use_torchode=True)}
# resblock "2" at the published widths (phase S3)
RESBLOCK2 = dict(resblock="2")
# card against CPU: waveforms at phase 3's bound; encode_torchaudio in
# decibels, its power spectrum taken in float64 as encode's magnitude is
# (the float32 one is printed beside it); the phase splice on the same
# inputs, whose float32 rounding moves it by 3.6e-7 on the CPU
SURFACE_TOL = {"wave": 1e-3, "encode_db": 1e-3, "splice": 1e-4}


def _adaptive_run(sr, audio: np.ndarray, in_sr: int):
    """``dispatch_generate`` as ``generate`` pads a clip: (out [1, T48]
    numpy, AdaptiveStats as numpy, host ms with the read-back)."""
    import torch

    from flowhigh_tpu_torch.sr import padded_length, valid_samples_48k
    n = len(audio)
    padded = np.zeros(padded_length(n, in_sr), np.float32)
    padded[:n] = audio
    if sr.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _, st = sr.dispatch_generate(padded[None], np.array([n]), in_sr)
    out = out[:, :valid_samples_48k(n, in_sr)].cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    stats = {"n_loops": int(st.n_loops), "n_accepted":
             st.n_accepted.cpu().tolist(), "converged":
             st.converged.cpu().tolist()}
    return out, stats, ms


def _solver_bound(sr, stats: dict, mel) -> float:
    """The adaptive solver's own bound on the RMS difference of two solves:
    one tolerance (atol + rtol max|y|, the error norm's scale) a step, over
    the larger count of accepted steps."""
    return max(stats) * (sr.ode_atol + sr.ode_rtol * float(mel.abs().max()))


def surface_phase(config, calls: dict, audio10: np.ndarray) -> dict:
    """Phase S (see the module docstring); ``calls`` is phase 2's
    ``main_path_calls``, ``audio10`` its 10 s clip."""
    import torch

    from flowhigh_tpu_torch import ops
    from flowhigh_tpu_torch.compat import seeded_init_
    from flowhigh_tpu_torch.dsp import (apply_mel, mel_filterbank_htk,
                                        resample_poly, stft)
    from flowhigh_tpu_torch.models import BigVGAN, encode_torchaudio, mel_encode
    from flowhigh_tpu_torch.postprocessing import post_process_with_phase
    from flowhigh_tpu_torch.profiling import clip_signal

    res: dict = {"paths": []}
    short = clip_signal(1.0, IN_SR)

    def path(name: str, counts: dict, ms: float, **extra) -> None:
        res["paths"].append({"name": name, "launches": {
            k: v for k, v in counts.items() if v}, "ms": ms, **extra})

    # S1: the adaptive generate, dopri5 then tsit5
    for name, kw in ADAPTIVE.items():
        sr = make_sr(config, "cuda", **kw)
        ops.reset_launch_counts()
        out, stats, ms_first = _adaptive_run(sr, audio10, IN_SR)
        counts = launch_counts()
        if out.shape != (1, int(SECONDS * 48000)) or not np.isfinite(
                out).all():
            raise AssertionError(f"phase S1 {name}: bad output {out.shape}")
        check_launches(f"phase S1: generate {name}", counts, calls)
        _, stats2, ms = _adaptive_run(sr, audio10, IN_SR)
        print(f"phase S1: generate(ode_method=adaptive, {name}) 10 s: "
              f"n_loops {stats['n_loops']} ({7 * stats['n_loops']} field "
              f"calls), n_accepted {stats['n_accepted']}, converged "
              f"{stats['converged']}; {ms:.1f} ms per clip (first run "
              f"{ms_first:.1f})", flush=True)
        if stats2 != stats or not all(stats["converged"]):
            raise AssertionError(f"phase S1 {name}: {stats} then {stats2}")
        g_out, g_st, _ = _adaptive_run(sr, short, IN_SR)
        sr_cpu = make_sr(config, "cpu", **kw)
        t0 = time.perf_counter()
        c_out, c_st, _ = _adaptive_run(sr_cpu, short, IN_SR)
        cpu_s = time.perf_counter() - t0
        diff = float(np.abs(g_out - c_out).max())
        entry = {"n_loops": stats["n_loops"],
                 "n_accepted": stats["n_accepted"],
                 "converged": stats["converged"], "ms": ms,
                 "card_1s": g_st, "cpu_1s": c_st, "card_vs_cpu": diff}
        if g_st["n_accepted"] == c_st["n_accepted"]:
            print(f"phase S1: {name} 1 s card vs CPU max abs {diff:.3e} "
                  f"(<= {SURFACE_TOL['wave']}), equal steps {g_st} (CPU run "
                  f"{cpu_s:.1f} s)", flush=True)
            if not diff <= SURFACE_TOL["wave"]:
                raise AssertionError(f"phase S1 {name}: card and CPU differ "
                                     f"by {diff}")
        else:  # a flipped accept: the two solves differ within tolerance
            batch = torch.from_numpy(short)[None]  # one 1 s bucket
            mels = []
            for m in (sr, sr_cpu):
                with torch.inference_mode():
                    mel, _, _, _ = m._prep_and_solve(
                        batch.to(m.device), torch.tensor([len(short)],
                                                         device=m.device),
                        m.generator(0), IN_SR, 48000, 1)
                mels.append(mel.cpu().double())
            rms = float((mels[0] - mels[1]).pow(2).mean().sqrt())
            bound = _solver_bound(sr, g_st["n_accepted"] + c_st[
                "n_accepted"], mels[1])
            entry.update(mel_rms_diff=rms, mel_bound=bound)
            print(f"phase S1: {name} 1 s: card steps {g_st}, CPU steps "
                  f"{c_st} (a flipped accept); waveform max abs {diff:.3e}; "
                  f"solved mels' RMS difference {rms:.3e} held to the "
                  f"solver's tolerance {bound:.3e}", flush=True)
            if not rms <= bound:
                raise AssertionError(f"phase S1 {name}: mels differ by {rms}")
        res[f"adaptive_{name}"] = entry
        path(f"FlowHighSR.generate(ode_method=adaptive, {name})", counts, ms,
             n_loops=stats["n_loops"])
        del sr, sr_cpu

    # S2: sample() on the 10 s clip's mel and on its audio
    sr = make_sr(config, "cuda")
    x48 = resample_poly(torch.from_numpy(audio10)[None], 48000, IN_SR)
    x48 = x48 / x48.abs().max()
    with torch.inference_mode():
        mel10 = mel_encode(x48.cuda())
    for what, cond in (("mel", mel10), ("audio", x48.cuda())):
        kw = dict(cond=cond, cond_scale=2.0, mel_pp=True, decode_to_audio=True)
        ops.reset_launch_counts()
        out = sr.sample(**kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        if out.shape != (1, mel10.shape[1] * 480) or not torch.isfinite(
                out).all():
            raise AssertionError(f"phase S2 {what}: bad output {out.shape}")
        check_launches(f"phase S2: sample(cond={what})", counts, calls)
        t0 = time.perf_counter()
        sr.sample(**kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        print(f"phase S2: sample(cond={what}, time_steps=4, cond_scale=2, "
              f"mel_pp, decode_to_audio) 10 s: out {tuple(out.shape)}, "
              f"{ms:.1f} ms", flush=True)
        res[f"sample_{what}_ms"] = ms
        path(f"FlowHighSR.sample(cond={what}, cond_scale=2.0, mel_pp=True)",
             counts, ms)
    x1 = x48[:, :48000]
    sr_cpu = make_sr(config, "cpu")
    with torch.inference_mode():
        mel1 = mel_encode(x1)
    for what, cond in (("mel", mel1), ("audio", x1)):
        kw = dict(cond_scale=2.0, mel_pp=True, decode_to_audio=True)
        got = sr.sample(cond=cond.cuda(), **kw).cpu()
        want = sr_cpu.sample(cond=cond, **kw)
        diff = float((got - want).abs().max())
        print(f"phase S2: sample(cond={what}) 1 s card vs CPU max abs "
              f"{diff:.3e} (<= {SURFACE_TOL['wave']})", flush=True)
        res[f"sample_{what}_card_vs_cpu"] = diff
        if not diff <= SURFACE_TOL["wave"]:
            raise AssertionError(f"phase S2 {what}: card and CPU differ")

    # S3: a full-width AMPBlock2 vocoder
    cfg2 = dataclasses.replace(config.vocoder, **RESBLOCK2)
    calls2 = main_path_calls(cfg2, mel10.shape[1])
    voc = seeded_init_(BigVGAN(cfg2).eval(), 1).cuda()
    with torch.inference_mode():
        ops.reset_launch_counts()
        out = voc(mel10)
        torch.cuda.synchronize()
        counts = launch_counts()
        check_launches("phase S3: AMPBlock2 vocoder", counts, calls2)
        if not torch.isfinite(out).all():
            raise AssertionError("phase S3: non-finite output")
        with replayed([]) as records:
            voc(mel10)
        worst = {}
        for inst, max_abs, _ in records:
            worst[inst] = max(worst.get(inst, 0.0), max_abs)
        print(f"phase S3: {len(records)} launches replayed against their "
              f"plain versions on their own inputs (atol / rtol {ATOL}): "
              f"max abs {worst}", flush=True)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            voc(mel10)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
        voc_cpu = BigVGAN(cfg2).eval()
        voc_cpu.load_state_dict({k: v.cpu() for k, v in
                                 voc.state_dict().items()})
        diff = float((voc(mel1.cuda()).cpu() - voc_cpu(mel1)).abs().max())
    print(f"phase S3: AMPBlock2 vocoder ({cfg2.upsample_initial_channel} "
          f"channels, rates "
          f"{cfg2.upsample_rates}) {ms:.2f} ms per 10 s clip (median of 5: "
          f"{[round(t, 2) for t in times]}); 1 s card vs CPU max abs "
          f"{diff:.3e} (<= {SURFACE_TOL['wave']})", flush=True)
    if not diff <= SURFACE_TOL["wave"]:
        raise AssertionError(f"phase S3: card and CPU differ by {diff}")
    res["resblock2"] = {"ms": ms, "ms_all": times, "card_vs_cpu": diff,
                        "replayed": len(records), "replay_max_abs": worst,
                        "launches": counts}
    path("BigVGAN(VocoderConfig(resblock='2'))", counts, ms)
    del voc, voc_cpu

    # S4: the soxr_hq front end, the torchaudio encode, the phase splice
    calls1 = main_path_calls(config.vocoder, 48000 // config.mel.hop_length)
    for in_sr in (16000, 44100):
        clip = clip_signal(1.0, in_sr)
        g = make_sr(config, "cuda", upsampling_method="librosa")
        c = make_sr(config, "cpu", upsampling_method="librosa")
        ops.reset_launch_counts()
        got = g.generate(clip, in_sr)
        counts = launch_counts()
        check_launches(f"phase S4: generate(upsampling_method=librosa) "
                       f"{in_sr} Hz", counts, calls1)
        want = c.generate(clip, in_sr)
        diff = float(np.abs(got - want).max())
        print(f"phase S4: generate(upsampling_method=librosa) 1 s at {in_sr} "
              f"Hz card vs CPU max abs {diff:.3e} (<= {SURFACE_TOL['wave']})",
              flush=True)
        res[f"librosa_{in_sr}_card_vs_cpu"] = diff
        if got.shape != (1, 48000) or not diff <= SURFACE_TOL["wave"]:
            raise AssertionError(f"phase S4 librosa {in_sr}: {diff}")
        path(f"FlowHighSR.generate(upsampling_method=librosa), 1 s at "
             f"{in_sr} Hz", counts, None)
        del g, c

    def encode_f32_fft(a):
        """encode_torchaudio with its power spectrum in float32."""
        spec = stft(a, 2048, 480, 2048, center=True, pad_mode="reflect")
        power = apply_mel(spec.real ** 2 + spec.imag ** 2,
                          mel_filterbank_htk(48000, 2048, 256, 0.0, 24000.0))
        return (10.0 * torch.log10(torch.clamp(power, min=1e-10))
                ).transpose(-1, -2)

    with torch.inference_mode():
        ta = {prec: float((enc(x1.cuda()).cpu() - enc(x1)).abs().max())
              for prec, enc in (("f64", encode_torchaudio),
                                ("f32_stft", encode_f32_fft))}
        out_g = sr.generate(short, IN_SR)
        pred = torch.from_numpy(out_g)
        splice = float((post_process_with_phase(pred.cuda(), x1.cuda(),
                                                48000).cpu()
                        - post_process_with_phase(pred, x1, 48000)
                        ).abs().max())
    print(f"phase S4: encode_torchaudio 1 s card vs CPU max abs {ta['f64']:.3e}"
          f" dB (float64 power, <= {SURFACE_TOL['encode_db']}; with a float32 "
          f"FFT {ta['f32_stft']:.3e} dB); post_process_with_phase 1 s card vs "
          f"CPU max abs {splice:.3e} (<= {SURFACE_TOL['splice']})", flush=True)
    res.update(encode_torchaudio_card_vs_cpu=ta, splice_card_vs_cpu=splice)
    if not (ta["f64"] <= SURFACE_TOL["encode_db"]
            and splice <= SURFACE_TOL["splice"] and np.isfinite(out_g).all()):
        raise AssertionError("phase S4: card and CPU differ")
    return res


# --- phase V: the vector field's options ----------------------------------------

# phase V's models: ModelConfig fields over the published FlowHighConfig
# (V1 the reference's ConvNeXt backbone, flow.py:124-139; V2 the published
# transformer with its three options, dense and on kernel F; V3 the
# published transformer computing in bf16)
V_MODELS = {
    "V1 convnext": dict(architecture="convnext"),
    "V2 options": dict(num_register_tokens=16, use_unet_skip_connection=True,
                       use_gateloop_layers=True),
    "V2 options flash": dict(num_register_tokens=16,
                             use_unet_skip_connection=True,
                             use_gateloop_layers=True, attn_flash=True),
    "V3 bf16": dict(compute_dtype="bfloat16"),
}
# the register-padded instance of kernel F in the kernels line
FLASH_REGISTERS = FLASH + "@registers"


@contextlib.contextmanager
def flash_replayed(records: list):
    """Every kernel-F launch of the transformer is also held against F's
    plain version evaluated in float64 on the same q, k, v and mask, at
    phase 1's tolerances (one block: atol 1e-4; several: max 5e-3, mean
    1e-4); ``records`` gets (q, k, v, mask, max abs, mean abs) per launch."""
    from flowhigh_tpu_torch import ops
    from flowhigh_tpu_torch.models import transformer
    from flowhigh_tpu_torch.ops.flash_attn import flash_block
    saved = transformer.flash_attention

    def call(q, k, v, mask, scale):
        got = saved(q, k, v, mask, scale)
        want = ops.flash_attention_plain(q.double(), k.double(), v.double(),
                                         mask, scale)
        d = (got.double() - want).abs()
        err_max, err_mean = float(d.max()), float(d.mean())
        n = q.shape[2]
        ok = (err_max <= 1e-4 if flash_block(n) >= n
              else err_max < 5e-3 and err_mean < 1e-4)
        if not ok or not bool(got.isfinite().all()):
            raise AssertionError(f"kernel F on {tuple(q.shape)} (registers "
                                 f"padded): max abs {err_max}, mean "
                                 f"{err_mean}")
        records.append((q, k, v, mask, err_max, err_mean))
        return got

    try:
        transformer.flash_attention = call
        yield records
    finally:
        transformer.flash_attention = saved


def _field_call(sr, audio: np.ndarray):
    """One call of the vector field on the card on the mel of ``audio``,
    all frames valid (one Euler step's field), as a function of nothing."""
    import torch

    from flowhigh_tpu_torch.dsp import resample_poly
    from flowhigh_tpu_torch.models import forward_with_cond_scale, mel_encode
    x = resample_poly(torch.from_numpy(audio)[None].cuda(), 48000, IN_SR)
    with torch.inference_mode():
        mel = mel_encode(x / x.abs().max())
    mask = torch.ones(mel.shape[:2], dtype=torch.bool, device="cuda")
    t0 = torch.zeros((), device="cuda")

    @torch.inference_mode()
    def call():
        return forward_with_cond_scale(sr.net, mel, times=t0, cond=mel,
                                       mask=mask)
    return call


def field_device_ms(sr, audio: np.ndarray) -> float:
    """Device ms (CUDA events, median of 5) of one call of the vector field
    on the mel of ``audio`` (``_field_call``)."""
    return time_ms(_field_call(sr, audio), 5, 2)


def field_stream_dtypes(sr, audio: np.ndarray) -> dict:
    """{module class: the dtypes of its outputs} over one call of the vector
    field on the card (``_field_call``), for the modules whose outputs join
    the residual stream: the conv embedding, each attention and each
    feed-forward. Under ``compute_dtype="bfloat16"`` each must be bf16,
    which only a bf16 product gives them (``transformer.dense``)."""
    from flowhigh_tpu_torch.models.transformer import (Attention,
                                                       ConvPositionEmbed,
                                                       FeedForward)
    seen: dict = {}

    def hook(module, _args, out):
        seen.setdefault(type(module).__name__, set()).add(str(out.dtype))

    handles = [m.register_forward_hook(hook) for m in sr.net.modules()
               if isinstance(m, (Attention, ConvPositionEmbed, FeedForward))]
    try:
        _field_call(sr, audio)()
    finally:
        for h in handles:
            h.remove()
    return {k: sorted(v) for k, v in seen.items()}


def flash_register_row(peaks, records: list) -> dict:
    """Kernel F at the register-padded shape of ``records`` (phase V's
    replay, one entry a launch): ``flash_row``'s times and bound over the
    launches of one clip, and the replay's largest errors."""
    import torch
    q, k, v, mask = records[0][:4]
    with torch.inference_mode():
        r = flash_row(peaks, q, k, v, mask)
    n_l = len(records)
    return {"launches": n_l, "shape": list(q.shape),
            "max_abs_err": max(x[4] for x in records),
            "mean_abs_err": max(x[5] for x in records),
            "ms": n_l * r["ms"], "plain_ms": n_l * r["plain_ms"],
            "library_ms": n_l * r["library_ms"],
            "bound_ms": n_l * max(r["bytes_ms"], r["ops_ms"]),
            "bound_by": ("bytes" if r["bytes_ms"] >= r["ops_ms"]
                         else "operations"),
            "unfused_chain_ms": None}


def options_phase(config, calls: dict, audio10: np.ndarray,
                  f32_out: np.ndarray, peaks) -> dict:
    """Phase V (see the module docstring); ``calls`` is phase 2's
    ``main_path_calls``, ``f32_out`` its default-path output of
    ``audio10``."""
    import torch

    from flowhigh_tpu_torch import log_spectral_distance
    from flowhigh_tpu_torch.profiling import clip_signal

    res: dict = {"paths": []}
    short = clip_signal(1.0, IN_SR)
    outs = {}
    for name, opts in V_MODELS.items():
        cfg = dataclasses.replace(
            config, model=dataclasses.replace(config.model, **opts))
        flash = 2 if cfg.model.attn_flash else 0  # one launch a layer
        sr = make_sr(cfg, "cuda")
        out, counts = run_main_path(sr, audio10, IN_SR)
        torch.cuda.synchronize()
        if out.shape != (1, int(SECONDS * 48000)) or not np.isfinite(
                out).all():
            raise AssertionError(f"phase {name}: bad output {out.shape}")
        check_launches(f"phase {name}", counts, calls, flash)
        times = clip_ms_of(sr, audio10)
        clip_ms = float(np.median(times))
        field_ms = field_device_ms(sr, audio10)
        dtypes = field_stream_dtypes(sr, audio10)
        want = str(sr.net.dtype)
        outs[name] = out
        r = {"clip_ms": clip_ms, "clip_ms_all": times,
             "field_device_ms": field_ms, "launches": counts,
             "stream_dtypes": dtypes}
        print(f"phase {name}: {clip_ms:.2f} ms per 10 s clip (median of 5: "
              f"{[round(t, 2) for t in times]}); vector field "
              f"{field_ms:.3f} device ms a call; vocoder launches as phase "
              f"2; the residual stream's module outputs {dtypes} (want "
              f"{want})", flush=True)
        if not dtypes or any(v != [want] for v in dtypes.values()):
            raise AssertionError(f"phase {name}: the field computed in "
                                 f"{dtypes}, not {want}")
        if cfg.model.compute_dtype != "float32":  # phase 2's weights
            r["rel_l2_vs_f32"] = rel_l2(out, f32_out)
            r["lsd_db_vs_f32"] = float(log_spectral_distance(f32_out,
                                                             out)[0])
            print(f"phase {name}: against phase 2's float32 output: rel L2 "
                  f"{r['rel_l2_vs_f32']:.4e}, LSD {r['lsd_db_vs_f32']:.4f} "
                  f"dB", flush=True)
        if flash:  # every launch of F replayed on its own inputs
            with flash_replayed([]) as records:
                sr.generate(audio10, IN_SR, timestep=1)
            if len(records) != flash:
                raise AssertionError(f"phase {name}: {len(records)} F "
                                     "launches replayed")
            row = flash_register_row(peaks, records)
            row["launches"] = counts[FLASH]  # the counted run's
            print(f"phase {name}: kernel F on register-padded "
                  f"{row['shape']}: {flash} launches each against its plain "
                  f"version in float64, max abs {row['max_abs_err']:.3e} "
                  f"mean abs {row['mean_abs_err']:.3e}; {row['ms']:.3f} ms "
                  f"a clip (plain {row['plain_ms']:.3f}, SDPA "
                  f"{row['library_ms']:.3f}, bound {row['bound_ms']:.3f} "
                  f"{row['bound_by']})", flush=True)
            res["flash_registers"] = row
            dense = outs["V2 options"]
            diff = float(np.abs(out - dense).max())
            print(f"phase {name}: flash against dense generate max abs "
                  f"{diff:.3e} (<= 1e-3)", flush=True)
            if not diff <= 1e-3:
                raise AssertionError(f"phase {name}: flash and dense differ "
                                     f"by {diff}")
            r["flash_vs_dense"] = diff
        out_gpu = sr.generate(short, IN_SR, timestep=1)
        del sr
        if not flash:  # card against CPU, 1 s
            sr_cpu = make_sr(cfg, "cpu")
            t0 = time.perf_counter()
            out_cpu = sr_cpu.generate(short, IN_SR, timestep=1)
            cpu_s = time.perf_counter() - t0
            if cfg.model.compute_dtype == "float32":
                diff = float(np.abs(out_gpu - out_cpu).max())
                print(f"phase {name}: 1 s card vs CPU max abs {diff:.3e} "
                      f"(<= 1e-3; CPU run {cpu_s:.1f} s)", flush=True)
                if out_gpu.shape != out_cpu.shape or not diff <= 1e-3:
                    raise AssertionError(f"phase {name}: card and CPU "
                                         f"differ by {diff}")
                r["card_vs_cpu"] = diff
            else:  # bf16 amplifies rounding: held as phase 3 holds phase P
                floor = max(rel_l2(sr_cpu.generate(
                    (short * np.float32(1 + s)).astype(np.float32), IN_SR,
                    timestep=1), out_cpu) for s in (NUDGE, -NUDGE))
                rel_cpu = rel_l2(out_gpu, out_cpu)
                bound = max(1e-2, 2 * floor)
                print(f"phase {name}: 1 s card vs CPU rel L2 {rel_cpu:.4e};"
                      f" the CPU against itself with the input nudged by "
                      f"+-2^-16: {floor:.4e}; bound max(1e-2, 2 x that) = "
                      f"{bound:.4e}", flush=True)
                if out_gpu.shape != out_cpu.shape or not rel_cpu <= bound:
                    raise AssertionError(f"phase {name}: card and CPU "
                                         f"disagree: {rel_cpu}")
                r["card_vs_cpu_rel_l2"] = rel_cpu
                r["nudge_floor_rel_l2"] = floor
            del sr_cpu
        res[name] = r
        res["paths"].append({"name": f"FlowHighSR.generate, ModelConfig("
                             + ", ".join(f"{k}={v!r}" for k, v in opts.items())
                             + ")", "launches": {k: v for k, v in
                                                 counts.items() if v},
                             "ms": clip_ms})
    return res


# --- phase T: the vector field's trainer -----------------------------------------

# T1's width (card against CPU), T3's batch, the waves' lengths (s); T2's
# batch is TrainConfig.batch_size (128)
T1_FIELD = dict(dim=64, depth=2, heads=2, dim_head=32)
T3_BATCH, T_SECONDS = 16, (2.0, 3.0)
T_WARMUP, T_TIMED, T_UPDATES = 3, 10, 20
# T1's bounds: card against CPU in float32 (TF32 off), identical draws
T1_GRAD_TOL, T1_PARAM_TOL = 1e-5, 1e-4
LAUNCH_EVENTS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")


def train_batch(b: int, seed: int, device: str) -> dict:
    """``b`` waves at 48 kHz padded to ``T_SECONDS[1]``, valid lengths
    uniform in ``T_SECONDS``: four tones and noise, zero past the length;
    the condition is the wave with every bin above a random cutoff of 2-12
    kHz zeroed (a band-limited input, as the training data degrades it).
    Made on ``device`` from ``seed``."""
    import torch
    kw = dict(generator=torch.Generator(device=device).manual_seed(seed),
              device=device)
    f64 = dict(dtype=torch.float64, **kw)
    n = int(T_SECONDS[1] * 48000)
    lengths = torch.randint(int(T_SECONDS[0] * 48000), n + 1, (b,), **kw)
    t = torch.arange(n, device=device, dtype=torch.float64) / 48000
    freqs = 100.0 + 19900.0 * torch.rand(b, 4, 1, **f64)
    wave = (0.1 * torch.sin(2 * np.pi * freqs * t).sum(1)
            + 0.02 * torch.randn(b, n, **f64))
    wave = torch.where(torch.arange(n, device=device)[None, :]
                       < lengths[:, None], wave, 0.0)
    spec = torch.fft.rfft(wave)
    cut = 2000.0 + 10000.0 * torch.rand(b, 1, **f64)
    freq = torch.fft.rfftfreq(n, 1 / 48000, device=device,
                              dtype=torch.float64)
    cond = torch.fft.irfft(torch.where(freq[None, :] > cut, 0.0, spec), n)
    return {"wave": wave.float(), "cond": cond.float(), "lengths": lengths}


def _t1(config) -> dict:
    """T1: the same small trainer on the card and the CPU, float32, one
    set of draws per update: update 1's loss and gradient, and the
    parameters after three updates."""
    import torch

    from flowhigh_tpu_torch.cfm import TrainingDraws, draw_training
    from flowhigh_tpu_torch.models import mel_encode
    from flowhigh_tpu_torch.train import Trainer
    cfg = config.replace(
        model=dataclasses.replace(config.model, **T1_FIELD),
        train=dataclasses.replace(config.train, amp_dtype="float32"))
    batch = train_batch(4, 1, "cpu")
    trs = {d: Trainer(cfg, device=d) for d in ("cuda", "cpu")}
    states = {d: tr.init_state(0) for d, tr in trs.items()}
    frames = mel_encode(torch.zeros(1, batch["wave"].shape[1]),
                        cfg.mel).shape[1]
    gen = torch.Generator().manual_seed(5)
    draws = [draw_training(gen, (4, frames, cfg.mel.n_mels), "cpu")
             for _ in range(3)]
    loss, grads = {}, {}
    for d, tr in trs.items():  # update 1's loss and gradient, unclipped
        net = states[d].net
        net.zero_grad(set_to_none=True)
        out = tr._loss_fn(net, *tr._batch(batch), train=True,
                          draws=TrainingDraws(*(a.to(d) for a in draws[0])))
        out.backward()
        loss[d] = float(out.detach())
        grads[d] = np.concatenate([
            (torch.zeros_like(p) if p.grad is None else p.grad).detach()
            .cpu().numpy().ravel() for p in net.parameters()])
        net.zero_grad(set_to_none=True)
    p0 = np.concatenate([p.detach().cpu().numpy().ravel()
                         for p in states["cpu"].net.parameters()])
    params = {}
    for d, tr in trs.items():
        for dr in draws:
            tr.train_step(states[d], batch,
                          draws=TrainingDraws(*(a.to(d) for a in dr)))
        params[d] = {k: p.detach().cpu().numpy()
                     for k, p in states[d].net.named_parameters()}
    flat = {d: np.concatenate([v.ravel() for v in ps.values()])
            for d, ps in params.items()}
    worst = max((rel_l2(params["cuda"][k], v), k)
                for k, v in params["cpu"].items() if np.any(v))
    res = {"loss_card": loss["cuda"], "loss_cpu": loss["cpu"],
           "loss_rel": abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"]),
           "grad_rel_l2": rel_l2(grads["cuda"], grads["cpu"]),
           "param_rel_l2": rel_l2(flat["cuda"], flat["cpu"]),
           "param_worst_leaf": list(worst),
           "update_rel_l2": rel_l2(flat["cuda"] - p0, flat["cpu"] - p0)}
    print(f"phase T1: dim {T1_FIELD['dim']}, float32, card vs CPU: update "
          f"1 loss {loss['cuda']:.6f} / {loss['cpu']:.6f} (rel "
          f"{res['loss_rel']:.3e}), gradient rel L2 {res['grad_rel_l2']:.3e} "
          f"(<= {T1_GRAD_TOL:g}); parameters after 3 updates rel L2 "
          f"{res['param_rel_l2']:.3e} (<= {T1_PARAM_TOL:g}; worst leaf "
          f"{worst[1]} {worst[0]:.3e}; the updates themselves "
          f"{res['update_rel_l2']:.3e})", flush=True)
    if not (res["loss_rel"] <= T1_GRAD_TOL
            and res["grad_rel_l2"] <= T1_GRAD_TOL
            and res["param_rel_l2"] <= T1_PARAM_TOL):
        raise AssertionError(f"phase T1: card and CPU disagree: {res}")
    return res


def host_launches(fn) -> dict:
    """One call of ``fn`` under torch.profiler: {"host_launches": kernel
    launch calls on the host, "device_kernels": kernels the card ran,
    "device_ms": their summed time, "top": the 8 kernels (name, ms, count)
    that took most of it}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_card = [e for e in events if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA]

    def ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    top = sorted(on_card, key=ms, reverse=True)[:8]
    return {"host_launches": sum(e.count for e in events
                                 if e.key in LAUNCH_EVENTS),
            "device_kernels": sum(e.count for e in on_card),
            "device_ms": sum(ms(e) for e in on_card),
            "top": [[e.key[:80], round(ms(e), 3), e.count] for e in top]}


def _t2(config, amp: str, batch: dict, weights: dict) -> dict:
    """T2 at one amp dtype: ms per update (median of ``T_TIMED`` after
    ``T_WARMUP``, each ending in a synchronize; the batch already on the
    card), peak memory over the timed updates, host launches of one
    update, and the loss over ``T_UPDATES`` updates on the fixed batch."""
    import torch

    from flowhigh_tpu_torch.train import Trainer
    tr = Trainer(config.replace(train=dataclasses.replace(
        config.train, amp_dtype=amp)), device="cuda")
    state = tr.init_state(0, params=weights)
    losses, times = [], []
    torch.cuda.synchronize()
    for i in range(T_UPDATES):
        if i == T_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = tr.train_step(state, batch)
        torch.cuda.synchronize()
        if T_WARMUP <= i < T_WARMUP + T_TIMED:
            times.append((time.perf_counter() - t0) * 1e3)
        if i == T_WARMUP + T_TIMED - 1:
            peak = torch.cuda.max_memory_allocated()
        losses.append(m["loss"])
    from flowhigh_tpu_torch import ops
    ops.reset_launch_counts()
    launches = host_launches(lambda: tr.train_step(state, batch))
    counts = {k: v for k, v in launch_counts().items() if v}
    losses = [float(v) for v in torch.stack(losses).cpu()]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    res = {"ms_per_update": float(np.median(times)), "ms_all": times,
           "peak_gib": peak / 2 ** 30, "losses": losses,
           "kernel_launches": counts, **launches}
    print(f"phase T2 {amp}: {res['ms_per_update']:.2f} ms per update "
          f"(median of {T_TIMED}: {[round(t, 2) for t in times]}), peak "
          f"{res['peak_gib']:.2f} GiB, {launches['host_launches']} host "
          f"launches ({launches['device_kernels']} device kernels, "
          f"{launches['device_ms']:.2f} device ms) an update, port kernels "
          f"{counts or 'none'}; loss over "
          f"{T_UPDATES} updates {losses[0]:.4f} -> {losses[-1]:.4f} (means "
          f"of the first and last 5: {first:.4f} -> {last:.4f}); the "
          f"kernels that took most of the update: {launches['top']}",
          flush=True)
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"phase T2 {amp}: the loss did not fall: "
                             f"{losses}")
    if counts:  # the field trains on cuBLAS; F refuses a gradient
        raise AssertionError(f"phase T2 {amp}: port kernels ran: {counts}")
    return res


def _t2_accum(config, batch: dict, weights: dict) -> None:
    """With ``grad_accum_every=2`` parameters move only on every second
    micro-step."""
    import torch

    from flowhigh_tpu_torch.train import Trainer
    tr = Trainer(config.replace(train=dataclasses.replace(
        config.train, grad_accum_every=2)), device="cuda")
    state = tr.init_state(0, params=weights)
    moved = []
    for _ in range(4):
        before = [p.detach().clone() for p in state.net.parameters()]
        state, _ = tr.train_step(state, batch)
        moved.append(any(not torch.equal(a, p)
                         for a, p in zip(before, state.net.parameters())))
    print(f"phase T2: grad_accum_every=2: parameters moved at micro-steps "
          f"{moved} (want [False, True, False, True])", flush=True)
    if moved != [False, True, False, True]:
        raise AssertionError(f"phase T2: accumulation moved {moved}")


def _t3(config, peaks, weights: dict) -> dict:
    """T3: ``attn_flash=True``: ``evaluate`` on kernel F (one launch a
    layer a batch, counted, then each replayed against its plain version)
    against the dense ``evaluate`` of the same weights; a train step
    refuses F's missing backward."""
    from flowhigh_tpu_torch import ops
    from flowhigh_tpu_torch.train import Trainer
    cfg = config.replace(train=dataclasses.replace(config.train,
                                                   amp_dtype="float32"))
    flash_cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                      attn_flash=True))
    batches = [train_batch(T3_BATCH, s, "cuda") for s in (3, 4)]
    tr = Trainer(flash_cfg, device="cuda")
    state = tr.init_state(0, params=weights)
    want = flash_cfg.model.depth * len(batches)  # a layer a batch
    ops.reset_launch_counts()
    flash = tr.evaluate(state, batches)
    counts = {k: v for k, v in launch_counts().items() if v}
    print(f"phase T3: evaluate with attn_flash=True on {len(batches)} "
          f"batches of {T3_BATCH}: launches {counts} (want {FLASH}: {want})",
          flush=True)
    if counts != {FLASH: want}:
        raise AssertionError(f"phase T3: launches {counts}")
    with flash_replayed([]) as records:
        again = tr.evaluate(state, batches)
    row = flash_register_row(peaks, records)
    row["launches"] = counts[FLASH]
    dense_tr = Trainer(cfg, device="cuda")
    dense = dense_tr.evaluate(dense_tr.init_state(0, params=weights),
                              batches)
    rel = abs(flash["valid_loss"] - dense["valid_loss"]) / abs(
        dense["valid_loss"])
    print(f"phase T3: {len(records)} launches of F each against its plain "
          f"version in float64 (max abs {row['max_abs_err']:.3e}, mean "
          f"{row['mean_abs_err']:.3e}), {row['ms']:.3f} ms an evaluate "
          f"(plain {row['plain_ms']:.3f}, SDPA {row['library_ms']:.3f}, bound "
          f"{row['bound_ms']:.3f} {row['bound_by']}); valid_loss flash "
          f"{flash['valid_loss']:.6f} / dense {dense['valid_loss']:.6f} (rel "
          f"{rel:.3e} <= 1e-3; replayed run {again['valid_loss']:.6f})",
          flush=True)
    if len(records) != want or not rel <= 1e-3:
        raise AssertionError(f"phase T3: {len(records)} replays, rel {rel}")
    try:
        tr.train_step(state, batches[0])
    except ValueError as e:
        print(f"phase T3: train_step with attn_flash=True raises "
              f"ValueError: {e}", flush=True)
    else:
        raise AssertionError("phase T3: train_step ran on kernel F")
    return {"flash": row, "valid_loss_flash": flash["valid_loss"],
            "valid_loss_dense": dense["valid_loss"], "rel": rel}


def train_phase(config, peaks) -> dict:
    """Phase T (see the module docstring); T2 and T3 start from one set of
    seeded weights."""
    from flowhigh_tpu_torch.compat import seeded_init_
    from flowhigh_tpu_torch.models import VectorFieldNet
    t0 = time.perf_counter()
    res = {"t1": _t1(config)}
    res["t1"]["s"] = time.perf_counter() - t0
    weights = seeded_init_(VectorFieldNet(config.model), 0).state_dict()
    batch = train_batch(config.train.batch_size, 2, "cuda")
    for amp in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        res[amp] = _t2(config, amp, batch, weights)
        res[amp]["s"] = time.perf_counter() - t0
    del batch
    _t2_accum(config, train_batch(T3_BATCH, 5, "cuda"), weights)
    t0 = time.perf_counter()
    res["t3"] = _t3(config, peaks, weights)
    res["t3"]["s"] = time.perf_counter() - t0
    print(f"phase T: T1 {res['t1']['s']:.1f} s, T2 bf16 "
          f"{res['bfloat16']['s']:.1f} s, float32 {res['float32']['s']:.1f} "
          f"s, T3 {res['t3']['s']:.1f} s", flush=True)
    return res


# --- phase D: the data pipeline and the CLI's train ------------------------------

# D1: the native chain against scipy on 3 s clips: (rate, order, ripple)
D1_CASES = [(rate, order, ripple) for rate in (4000, 8000, 16000, 32000)
            for order, ripple in ((1, 1e-9), (8, 0.05), (11, 5.0))]
# D2: the batch iterator's configurations (worker_type, num_workers); the
# spawn pool is timed over D2_BATCHES batches after its coordinators'
# first two (the first includes the workers' start-up)
D2_RUNS = (("thread", 2), ("thread", 8), ("process", 8))
D2_BATCHES = 4
# D3: the device sosfiltfilt: the check's filters (order, ripple, cutoff),
# the check and timing shapes, the batch's (a 3 s crop of 128 waves)
D3_FILTERS = ((1, 1e-9, 0.5), (8, 0.05, 1 / 3), (11, 5.0, 1 / 12))
D3_CHECK, D3_TIMED, D3_BATCH = (2, 4000), (128, 4000), (128, 144000)
D3_ATOL, D3_SCIPY_ATOL = 1e-5, 2e-3
SOSFILT = "sosfilt"
# one sample of one section: 5 products and 4 sums (csrc/sosfilt.cu); the
# loop-carried chain of a section: a sum, a product, a difference, at an
# FP32 latency of 4 cycles
SOS_OPS, SOS_CHAIN, FP32_LATENCY = 9, 3, 4
D4_UPDATES = 3


class _TimedIter:
    """Wraps an iterator: ``times`` collects (seconds spent in ``next``,
    the clock when it returned) for each item."""

    def __init__(self, it):
        self.it, self.times = it, []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = next(self.it)
        t1 = time.perf_counter()
        self.times.append((t1 - t0, t1))
        return item

    def close(self):
        self.it.close()


def _update_figures(times: list, t_end: float) -> dict:
    """From a fit's batch timings: each update's wall time, from one
    batch's hand-over to the next's (the update and the wait for the next
    batch), that wait, the first batch's wait, and the share of the whole
    run (first ``next`` to ``t_end``) spent in ``next``."""
    walls = [(b[1] - a[1]) * 1e3 for a, b in zip(times, times[1:])]
    waits = [b[0] * 1e3 for b in times[1:]]
    total = t_end - (times[0][1] - times[0][0])
    return {"ms_per_update": walls, "wait_ms": waits,
            "first_batch_s": times[0][0], "wall_s": total,
            "wait_share": sum(t for t, _ in times) / total}


def _d1() -> dict:
    from flowhigh_tpu_torch import native
    from flowhigh_tpu_torch.dsp import host_degrade
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"phase D1: the native library did not build: "
                             f"{native._lib_error}")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(11)
    wave = rng.standard_normal(3 * 48000)
    wave /= np.abs(wave).max()
    worst = 0.0
    for rate, order, ripple in D1_CASES:
        got = native.host_degrade(wave, 48000, rate, order, ripple)
        want = host_degrade(wave, 48000, rate, order, ripple, engine="scipy")
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"phase D1: native library built and loaded in {build_s:.1f} s; "
          f"host_degrade on 3 s clips at {len(D1_CASES)} (rate, order) cases "
          f"against scipy: max abs {worst:.3e} (rtol 1e-9, atol 1e-10)",
          flush=True)
    return {"build_s": build_s, "max_abs_vs_scipy": worst}


def _d2(config) -> list:
    import os

    from flowhigh_tpu_torch.train import SyntheticAudioDataset, batch_iterator
    ds = SyntheticAudioDataset(config.data, n_items=256, seconds=3.0)
    b = config.train.batch_size
    t0 = time.perf_counter()
    for i in range(16):
        ds[i]
    one = 16 / (time.perf_counter() - t0)
    res = [{"worker_type": "serial", "num_workers": 1, "clips_per_s": one}]
    print(f"phase D2: host CPUs {os.cpu_count()}; one clip at a time "
          f"(synthetic 3 s clip and its native degradation): {one:.1f} "
          f"clips/s", flush=True)
    for worker_type, n in D2_RUNS:
        # threads: every worker's first batch from a cold start (one round,
        # no batch made ahead of the window); processes: after the pool has
        # started and both coordinators have delivered
        n_batches = n if worker_type == "thread" else 2 + D2_BATCHES
        t0 = time.perf_counter()
        it = batch_iterator(ds, b, seed=1, pad_to=3 * 48000, num_workers=n,
                            worker_type=worker_type)
        try:
            stamps = []
            for _ in range(n_batches):
                next(it)
                stamps.append(time.perf_counter())
        finally:
            it.close()
        start, n_timed = ((t0, n) if worker_type == "thread"
                          else (stamps[1], D2_BATCHES))
        rate = n_timed * b / (stamps[-1] - start)
        res.append({"worker_type": worker_type, "num_workers": n,
                    "clips_per_s": rate, "first_batch_s": stamps[0] - t0,
                    "ms_per_batch": (stamps[-1] - start) * 1e3 / n_timed})
        print(f"phase D2: batch_iterator({worker_type}, {n} workers), batch "
              f"{b} of 3 s: first batch {stamps[0] - t0:.2f} s; {rate:.1f} "
              f"clips/s over {n_timed} batches", flush=True)
    return res


def _sos_bounds(peaks, rows: int, t_ext: int, n_sec: int, clock_mhz) -> dict:
    """Two passes over [rows, t_ext]: bytes (read and write each pass) and
    operations at the card's peaks, and the serial bound of one thread's
    row: the larger of the section's loop-carried chain and the 9 S
    float32 instructions a warp issues a sample, one a cycle."""
    bytes_ms = 2 * 2 * rows * t_ext * 4 / peaks[1] * 1e3
    ops_ms = 2 * rows * t_ext * n_sec * SOS_OPS / peaks[0] * 1e3
    cycles = max(SOS_CHAIN * FP32_LATENCY, SOS_OPS * n_sec)
    serial_ms = (2 * t_ext * cycles / (clock_mhz * 1e3)
                 if clock_mhz else None)
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "serial_bound_ms": serial_ms, "cycles_per_sample": cycles}


def _d3(peaks, clock_mhz) -> dict:
    import scipy.signal as sps
    import torch

    from flowhigh_tpu_torch import ops
    from flowhigh_tpu_torch.dsp import cheby1_sos, sosfiltfilt
    from flowhigh_tpu_torch.dsp.filters import padlen
    from flowhigh_tpu_torch.ops.iir import cascade, sosfilt_plain
    rng = np.random.default_rng(12)
    x = (0.5 * rng.standard_normal(D3_CHECK)).astype(np.float32)
    worst, worst_scipy = 0.0, 0.0
    for order, ripple, wn in D3_FILTERS:
        sos = cheby1_sos(order, ripple, wn)
        got = sosfiltfilt(sos, torch.from_numpy(x).cuda()).cpu().numpy()
        plain = sosfiltfilt(sos, torch.from_numpy(x)).numpy()
        ref = sps.sosfiltfilt(sos, x.astype(np.float64))
        d, ds = float(np.abs(got - plain).max()), float(np.abs(got - ref).max())
        print(f"phase D3: sosfiltfilt order {order} ripple {ripple:g} cutoff "
              f"{wn:.4g} on {D3_CHECK}: kernel vs plain max abs {d:.3e} (<= "
              f"{D3_ATOL:g}), vs scipy {ds:.3e} (<= {D3_SCIPY_ATOL:g})",
              flush=True)
        if not (d <= D3_ATOL and ds <= D3_SCIPY_ATOL):
            raise AssertionError(f"phase D3: order {order}: {d}, {ds}")
        worst, worst_scipy = max(worst, d), max(worst_scipy, ds)
    # the path: a batch's 3 s crops through the device sosfiltfilt, counted
    order, ripple, wn = D3_FILTERS[-1]
    sos = cheby1_sos(order, ripple, wn)
    coefs = cascade(sos, sps.sosfilt_zi(sos))
    n_sec, pad = sos.shape[0], padlen(sos)
    xb = 0.5 * torch.randn(D3_BATCH, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
    ops.reset_launch_counts()
    yb = sosfiltfilt(sos, xb)
    torch.cuda.synchronize()
    launches = ops.sosfilt.launches
    rows_ref = sps.sosfiltfilt(sos, xb[:2].double().cpu().numpy())
    d_batch = float(np.abs(yb[:2].cpu().numpy() - rows_ref).max())
    print(f"phase D3: sosfiltfilt on {D3_BATCH}: {launches} launches of "
          f"{SOSFILT} (want 2), finite {bool(torch.isfinite(yb).all())}, "
          f"rows 0-1 vs scipy max abs {d_batch:.3e}", flush=True)
    if launches != 2 or not torch.isfinite(yb).all() \
            or not d_batch <= D3_SCIPY_ATOL:
        raise AssertionError(f"phase D3: batch: {launches}, {d_batch}")

    def passes(x_ext, fn):
        return lambda: fn(coefs, fn(coefs, x_ext), reverse=True)
    ext_b = torch.randn(D3_BATCH[0], D3_BATCH[1] + 2 * pad, device="cuda")
    crop_ms = time_ms(passes(ext_b, ops.sosfilt), reps=5, warmup=1)
    crop = {"shape": list(ext_b.shape), "ms": crop_ms,
            **_sos_bounds(peaks, *ext_b.shape, n_sec, clock_mhz)}
    ext_t = torch.randn(D3_TIMED[0], D3_TIMED[1] + 2 * pad, device="cuda")
    ms = time_ms(passes(ext_t, ops.sosfilt))
    plain_ms = time_ms(passes(ext_t, sosfilt_plain), reps=1, warmup=0)
    err = float((passes(ext_t, ops.sosfilt)()
                 - passes(ext_t, sosfilt_plain)()).abs().max())
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "unfused_chain_ms": None, "launches": launches,
           "max_abs_err": max(worst, err), "shape": list(ext_t.shape),
           **_sos_bounds(peaks, *ext_t.shape, n_sec, clock_mhz),
           "crop": crop, "max_abs_vs_scipy": worst_scipy}
    print(f"phase D3: two passes (order {order}, {n_sec} sections) on "
          f"{list(ext_t.shape)}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms "
          f"(max abs {err:.3e}), bound {row['bound_ms']:.4f} "
          f"{row['bound_by']}, serial bound {row['serial_bound_ms']}; on "
          f"{crop['shape']}: kernel {crop_ms:.3f} ms, bound "
          f"{crop['bound_ms']:.4f} {crop['bound_by']}, serial bound "
          f"{crop['serial_bound_ms']} ms ({crop['cycles_per_sample']} cycles "
          f"a sample and pass at {clock_mhz} MHz)", flush=True)
    if not err <= D3_ATOL:
        raise AssertionError(f"phase D3: kernel vs plain {err}")
    return row


def _d4(config) -> dict:
    import shutil

    import torch

    import flowhigh_tpu_torch.train as train_pkg
    from flowhigh_tpu_torch import cli, ops
    from flowhigh_tpu_torch.train import (SyntheticAudioDataset, Trainer,
                                          batch_iterator, random_split)
    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg_path = work / "config.json"
    cfg_path.write_text(json.dumps({
        "data": {"data_path": ""}, "model": {},
        "train": {"batchsize": config.train.batch_size, "log_every": 1,
                  "save_model_every": D4_UPDATES}}))
    out = work / "results"
    timed = []
    real = train_pkg.batch_iterator

    def spy(*args, **kw):  # time the training iterator, the first asked for
        it = real(*args, **kw)
        if not timed:
            it = _TimedIter(it)
            timed.append(it)
        return it
    res = {}
    try:
        train_pkg.batch_iterator = spy
        for steps in (D4_UPDATES, D4_UPDATES + 1):
            timed.clear()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(["train", "--config", str(cfg_path), "--steps",
                           str(steps), "--save_dir", str(out)])
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            counts = {k: v for k, v in launch_counts().items() if v}
            if ops.sosfilt.launches:
                counts[SOSFILT] = ops.sosfilt.launches
            fig = _update_figures(timed[0].times, t_end)
            res[f"steps_{steps}"] = {"rc": rc, "s": t_end - t0,
                                     "kernel_launches": counts, **fig}
            print(f"phase D4: cli train --steps {steps}: rc {rc} in "
                  f"{t_end - t0:.1f} s; ms per update "
                  f"{[round(w, 1) for w in fig['ms_per_update']]}, of which "
                  f"waiting on the data {[round(w, 1) for w in fig['wait_ms']]}"
                  f" (first batch {fig['first_batch_s']:.2f} s); share of the "
                  f"fit spent in next(data_iter) {fig['wait_share']:.3f}; port "
                  f"kernels {counts or 'none'}", flush=True)
            if rc != 0:
                raise AssertionError(f"phase D4: cli train returned {rc}")
    finally:
        train_pkg.batch_iterator = real
    lines = [json.loads(ln) for ln in
             (out / "metrics.jsonl").read_text().splitlines()]
    steps = [ln["step"] for ln in lines if "loss" in ln]
    losses = [ln["loss"] for ln in lines if "loss" in ln]
    print(f"phase D4: metrics.jsonl steps {steps}, losses "
          f"{[round(v, 4) for v in losses]}; saved "
          f"{sorted(p.name for p in out.glob('*.pt'))}", flush=True)
    want = list(range(1, D4_UPDATES + 2))
    if steps != want or not np.isfinite(losses).all() \
            or not (out / f"trainstate_{D4_UPDATES}.pt").exists():
        raise AssertionError(f"phase D4: steps {steps}, losses {losses}")
    res["steps"], res["losses"] = steps, losses

    # the same iterator without device_prefetch: Trainer.fit uploads each
    # numpy batch inside its step
    cfg = config
    ds = SyntheticAudioDataset(cfg.data, n_items=256, seconds=3.0)
    train_ds, _ = random_split(ds, cfg.train.valid_frac,
                               cfg.train.random_split_seed)
    tr = Trainer(cfg.replace(train=dataclasses.replace(
        cfg.train, log_every=1, save_model_every=0)),
        results_folder=str(work / "no_prefetch"), device="cuda")
    it = _TimedIter(batch_iterator(train_ds, cfg.train.batch_size,
                                   pad_to=3 * 48000))
    try:
        tr.fit(it, num_steps=D4_UPDATES, log_fn=lambda *_: None)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        batch = next(it)
    finally:
        it.close()
    fig = _update_figures(it.times[:D4_UPDATES], t_end)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr._batch(batch)
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    res["no_prefetch"] = {**fig, "upload_ms": upload_ms}
    print(f"phase D4: Trainer.fit, device_prefetch=False: ms per update "
          f"{[round(w, 1) for w in fig['ms_per_update']]}, of which waiting "
          f"on the data {[round(w, 1) for w in fig['wait_ms']]}; share in "
          f"next(data_iter) {fig['wait_share']:.3f}; one batch's synchronous "
          f"upload from pageable memory {upload_ms:.1f} ms", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return res


def data_phase(config, peaks, clock_mhz) -> dict:
    """Phase D (see the module docstring)."""
    res = {}
    for name, fn in (("d1", _d1), ("d2", lambda: _d2(config)),
                     ("d3", lambda: _d3(peaks, clock_mhz)),
                     ("d4", lambda: _d4(config))):
        t0 = time.perf_counter()
        res[name] = fn()
        res[f"{name}_s"] = time.perf_counter() - t0
    print(f"phase D: D1 {res['d1_s']:.1f} s, D2 {res['d2_s']:.1f} s, D3 "
          f"{res['d3_s']:.1f} s, D4 {res['d4_s']:.1f} s", flush=True)
    return res


# --- phase W: the vocoder's GAN training ------------------------------------------

# W1: tests/test_torch_vocoder_train.py's tiny GAN; its (8, 16) and (4, 8)
# upsamplers take kernel C, the odd (5, 10) and (3, 6) the library conv
W1_VOCODER = dict(num_mels=256, upsample_initial_channel=16,
                  upsample_rates=(8, 5, 4, 3),
                  upsample_kernel_sizes=(16, 10, 8, 6),
                  resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
W1_TRAINER = dict(segment_frames=8, periods=(2,),
                  resolutions=((512, 50, 240),))
W1_STEPS = 3
# W1's bounds are phase T1's: step 1's losses and gradients, the
# parameters after the steps (each held instead to twice the CPU's own
# change under a +-NUDGE of the waves, where that is larger)
W1_TOLS = {"loss": T1_GRAD_TOL, "grad": T1_GRAD_TOL, "param": T1_PARAM_TOL}
# W2 and W3: the published generator on 32-frame (15,360-sample) segments
W_FRAMES, W_BATCH = 32, 16
W_GRAD_TOL = 1e-5  # W2: each gradient against the plain version's, rel L2
W2_REPS, W2_WARMUP = 5, 2
W3_WARMUP, W3_TIMED = 2, 5
GAN_KERNELS = ("snake_aa", "conv1d_same", "conv_transpose1d")


def _w1_run(tr, wave: np.ndarray) -> dict:
    """``W1_STEPS`` GAN steps of ``tr`` from seed 0 on ``wave``: each step's
    metrics, step 1's gradients (None where a parameter got none) and the
    parameters after the last step, on the host."""
    state, metrics, grads = tr.init_state(0), [], None
    named = [(f"{m}.{n}", p) for m in ("generator", "mpd", "mrd")
             for n, p in getattr(state, m).named_parameters()]
    for i in range(W1_STEPS):
        state, m = tr.train_step(state, {"wave": wave})
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {k: None if p.grad is None else p.grad.cpu().numpy()
                     for k, p in named}
    return {"metrics": metrics, "grads": grads,
            "params": {k: p.detach().cpu().numpy() for k, p in named}}


def _w1() -> dict:
    """W1: the tiny GAN trainer on the card and on the CPU from the same
    weights and waves, float32."""
    from flowhigh_tpu_torch.config import VocoderConfig
    from flowhigh_tpu_torch.train import VocoderTrainer
    cfg = VocoderConfig(**W1_VOCODER)
    trs = {d: VocoderTrainer(cfg, device=d, **W1_TRAINER)
           for d in ("cuda", "cpu")}
    wave = (np.random.default_rng(0).standard_normal(
        (2, trs["cpu"].segment_samples)) * 0.3).astype(np.float32)
    runs = {d: _w1_run(tr, wave) for d, tr in trs.items()}
    cpu = runs["cpu"]
    missing = [k for k, g in runs["cuda"]["grads"].items()
               if g is None and cpu["grads"][k] is not None]
    if missing:  # never read as zeros
        raise AssertionError(f"phase W1: no gradient on the card for "
                             f"{missing}")

    def flat(d):
        return np.concatenate([v.ravel() for v in d.values()])

    def figures(run):
        m, m0 = run["metrics"][0], cpu["metrics"][0]
        return {"loss": max(abs(m[k] - m0[k]) / abs(m0[k]) for k in m0),
                "grad": rel_l2(flat(run["grads"]), flat(cpu["grads"])),
                "param": rel_l2(flat(run["params"]), flat(cpu["params"]))}
    card = figures(runs["cuda"])
    nudged = [figures(_w1_run(trs["cpu"], wave * np.float32(1 + s)))
              for s in (NUDGE, -NUDGE)]
    floor = {k: max(n[k] for n in nudged) for k in card}
    by_module = {m: rel_l2(
        np.concatenate([v.ravel() for k, v in runs["cuda"]["grads"].items()
                        if k.startswith(m)]),
        np.concatenate([v.ravel() for k, v in cpu["grads"].items()
                        if k.startswith(m)])) for m in ("generator", "mpd",
                                                        "mrd")}
    print(f"phase W1: tiny GAN trainer, float32, card vs CPU: step 1 losses "
          f"{runs['cuda']['metrics'][0]} / {cpu['metrics'][0]}; " + "; ".join(
              f"{k} {card[k]:.3e} (bound {W1_TOLS[k]:g}, the CPU's own change "
              f"under a +-2^-16 nudge of the waves {floor[k]:.3e})"
              for k in card) + f"; step 1 gradients by module {by_module}; "
          f"{len(runs['cuda']['grads'])} parameters, each with a gradient",
          flush=True)
    if not all(card[k] <= max(W1_TOLS[k], 2 * floor[k]) for k in card):
        raise AssertionError(f"phase W1: card and CPU disagree: {card}, "
                             f"nudge {floor}")
    return {"card_vs_cpu": card, "cpu_nudge": floor,
            "grad_by_module": by_module,
            "losses": [r["metrics"] for r in runs.values()]}


def _w2_case(kernel: str, key, randn):
    """(kernel call, plain call, inputs that require a gradient, output
    shape) at one shape key of the unfused path, batch ``W_BATCH``."""
    from flowhigh_tpu_torch import ops
    b = W_BATCH
    if kernel == "snake_aa":
        c, t = key
        xs = [randn(b, c, t), randn(c, scale=0.3), randn(c, scale=0.3)]
        return (lambda x, a, be: ops.snake_activation1d(x, a, be),
                lambda x, a, be: ops.snake_activation1d_plain(x, a, be),
                xs, (b, c, t))
    if kernel == "conv1d_same":
        cin, cout, t, k, d, n_res, scale = key
        xs = [randn(b, cin, t), randn(cout, cin, k, scale=(cin * k) ** -0.5),
              randn(cout, scale=0.1)] + [randn(b, cout, t)
                                         for _ in range(n_res)]
        kw = dict(dilation=d, out_scale=scale)
        return (lambda x, w, bb, *r: ops.conv1d(x, w, bb, residuals=r, **kw),
                lambda x, w, bb, *r: ops.conv1d_plain(x, w, bb, residuals=r,
                                                      **kw),
                xs, (b, cout, t))
    cin, cout, t, u, k = key
    xs = [randn(b, cin, t), randn(cin, cout, k, scale=(cout * k) ** -0.5),
          randn(cout, scale=0.1)]
    return (lambda x, w, bb: ops.conv_transpose1d(x, w, bb, stride=u),
            lambda x, w, bb: ops.conv_transpose1d_plain(x, w, bb, stride=u),
            xs, (b, cout, u * t))


def _w2(cfg) -> dict:
    """W2: kernels A, B and C under autograd at every shape of the
    generator's forward on a batch of ``W_BATCH`` x ``W_FRAMES`` frames:
    each gradient against the plain version's (rel L2), and per shape the
    kernel's forward, the Function's backward and the plain version's
    backward, timed with CUDA events; summed over the path's launches."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    calls = main_path_calls(cfg, W_FRAMES, fuse_act_conv=False)
    out = {}
    for kernel in GAN_KERNELS:
        tot = {"launches": 0, "shapes": len(calls[kernel]), "fwd_ms": 0.0,
               "bwd_ms": 0.0, "plain_fwd_ms": 0.0, "plain_bwd_ms": 0.0,
               "grad_rel_l2": 0.0}
        for key, n in calls[kernel].items():
            fn, plain, xs, shape = _w2_case(kernel, key, randn)
            g = randn(*shape)
            ka = [x.requires_grad_() for x in xs]
            kp = [x.detach().clone().requires_grad_() for x in xs]
            ya, yp = fn(*ka), plain(*kp)
            ga = torch.autograd.grad(ya, ka, g, retain_graph=True)
            gp = torch.autograd.grad(yp, kp, g, retain_graph=True)
            worst = max(rel_l2(a.cpu(), b.cpu()) for a, b in zip(ga, gp))
            if not worst <= W_GRAD_TOL:
                raise AssertionError(f"phase W2: {kernel} {key}: gradient rel "
                                     f"L2 {worst:.3e}")
            timed = {
                "fwd_ms": lambda: fn(*ka),
                "bwd_ms": lambda: torch.autograd.grad(ya, ka, g,
                                                      retain_graph=True),
                "plain_fwd_ms": lambda: plain(*kp),
                "plain_bwd_ms": lambda: torch.autograd.grad(
                    yp, kp, g, retain_graph=True)}
            for f, call in timed.items():
                tot[f] += n * time_ms(call, W2_REPS, W2_WARMUP)
            tot["launches"] += n
            tot["grad_rel_l2"] = max(tot["grad_rel_l2"], worst)
            del ya, yp, ga, gp, ka, kp
        print(f"phase W2: {kernel}: {tot['launches']} launches a generator "
              f"forward over {tot['shapes']} shapes ([{W_BATCH}, C, T] at "
              f"{W_FRAMES} frames): gradients within rel L2 "
              f"{tot['grad_rel_l2']:.3e} (<= {W_GRAD_TOL:g}) of the plain "
              f"version's; forward {tot['fwd_ms']:.2f} ms (plain "
              f"{tot['plain_fwd_ms']:.2f}), backward {tot['bwd_ms']:.2f} ms "
              f"(plain {tot['plain_bwd_ms']:.2f}) summed over the launches",
              flush=True)
        out[kernel] = tot
    return out


def _kernel_split(prof) -> dict:
    """Device ms of one profiled GAN step by kernel name, grouped: the
    port's kernels (forward), the other kernels whose names mark a
    backward pass (cuDNN's dgrad / wgrad, autograd's ``backward``), and
    the rest (the forward's library kernels, the FFTs, the optimizers'
    elementwise kernels); with the ten largest."""
    import torch
    port = ("snake_aa_kernel", "conv1d_mma_kernel", "conv1d_narrow_kernel",
            "conv_transpose1d_kernel")
    groups = {"port_forward": 0.0, "backward": 0.0, "other": 0.0}
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        name = e.key.lower()
        grp = ("port_forward" if any(p in name for p in port) else
               "backward" if any(p in name for p in (
                   "dgrad", "wgrad", "backward", "bwd")) else "other")
        groups[grp] += ms
        rows.append((ms, e.key[:80], e.count, grp))
    rows.sort(reverse=True)
    return {**groups, "top": [[k, round(ms, 3), n, g]
                              for ms, k, n, g in rows[:10]]}


def _w3(cfg) -> dict:
    """W3: the published generator, the default MPD and MRD, batches of
    ``W_BATCH`` segments of ``W_FRAMES`` frames from
    ``VocoderSegmentDataset`` over ``SyntheticAudioDataset``: ms a GAN step
    (median of ``W3_TIMED`` after ``W3_WARMUP``, each ending in a
    synchronize), peak memory, the launches of one step (counted, against
    the unfused path's), and the device time by kernel of one step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flowhigh_tpu_torch import ops
    from flowhigh_tpu_torch.train import (SyntheticAudioDataset,
                                          VocoderSegmentDataset,
                                          VocoderTrainer)
    tr = VocoderTrainer(cfg, segment_frames=W_FRAMES, device="cuda")
    state = tr.init_state(0)
    data = VocoderSegmentDataset(SyntheticAudioDataset(n_items=W_BATCH,
                                                       seconds=1.0),
                                 segment_samples=tr.segment_samples)
    batch = {"wave": torch.from_numpy(np.stack(
        [data[i]["wave"] for i in range(W_BATCH)])).cuda()}
    want = {k: sum(v.values()) for k, v in main_path_calls(
        cfg, W_FRAMES, fuse_act_conv=False).items()}
    times, losses = [], []
    torch.cuda.synchronize()
    for i in range(W3_WARMUP + W3_TIMED):
        if i == W3_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = tr.train_step(state, batch)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items()
                  if k in KERNEL_NAMES}
        if counts != want:
            raise AssertionError(f"phase W3: step {i} launched {counts}, "
                                 f"want {want}")
        if i >= W3_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_step(state, batch)
        torch.cuda.synchronize()
    split = _kernel_split(prof)
    n_params = {m: sum(p.numel() for p in getattr(state, m).parameters())
                for m in ("generator", "mpd", "mrd")}
    res = {"ms_per_step": float(np.median(times)), "ms_all": times,
           "peak_gib": peak, "launches": counts, "losses": losses,
           "params": n_params, **split}
    print(f"phase W3: published generator ({n_params['generator']:,} "
          f"parameters), MPD ({n_params['mpd']:,}), MRD ({n_params['mrd']:,}),"
          f" batch {W_BATCH} x {tr.segment_samples} samples: "
          f"{res['ms_per_step']:.1f} ms a GAN step (median of {W3_TIMED}: "
          f"{[round(t, 1) for t in times]}), peak {peak:.2f} GiB, launches a "
          f"step {counts}; device ms of one step: port kernels (forward) "
          f"{split['port_forward']:.1f}, backward-named kernels "
          f"{split['backward']:.1f}, other {split['other']:.1f}; the largest "
          f"{split['top']}; losses {losses[0]} -> {losses[-1]}", flush=True)
    if not all(np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"phase W3: losses {losses}")
    return res


def gan_phase(config) -> dict:
    """Phase W (see the module docstring)."""
    t0 = time.perf_counter()
    res = {"w1": _w1()}
    res["w1"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["w2"] = _w2(config.vocoder)
    res["w2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["w3"] = _w3(config.vocoder)
    res["w3"]["s"] = time.perf_counter() - t0
    print(f"phase W: W1 {res['w1']['s']:.1f} s, W2 {res['w2_s']:.1f} s, W3 "
          f"{res['w3']['s']:.1f} s", flush=True)
    return res


# --- phase M: the probe kernels --------------------------------------------------

# probe instance -> the probe script's row that launches it
PROBE_ROWS = {"snake_aa.firs": "firs_only", "snake_only": "snake_floor",
              "mxu_fir": "mxu_fir f32", "mxu_fir.dots": "mxu_fir f32 dots_only",
              "mxu_fir.bf16": "mxu_fir bf16",
              "mxu_fir.bf16_dots": "mxu_fir bf16 dots_only"}
# bf16 H against its plain version: (rel L2, max abs over max(1, max |plain|));
# kernel and plain sum s2 in other orders, so now and then a bf16 rounding
# of s2 flips and moves one output row by a bf16 step of s2 times dn
PROBE_BF16_TOL = (1e-3, 1e-2)


def _load_probe_script():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "port_bench_act_mxu", ROOT / "scripts" / "port_bench_act_mxu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_counts() -> dict:
    """{instance: launches} of the probe path's kernels since the last
    ``ops.reset_launch_counts``."""
    from flowhigh_tpu_torch import ops
    h = ops.mxu_fir.instance_launches
    return {"snake_aa": ops.snake_activation1d.launches,
            "conv1d_same": ops.conv1d.launches,
            "snake_aa.firs": ops.act_firs_only.launches,
            "snake_only": ops.snake_only.launches,
            "mxu_fir": h["mxu_fir_f32"], "mxu_fir.dots": h["mxu_fir_f32_dots"],
            "mxu_fir.bf16": h["mxu_fir_bf16"],
            "mxu_fir.bf16_dots": h["mxu_fir_bf16_dots"]}


def _compare_probe(inst: str, case: str, got, want) -> float:
    """Max abs error of a probe kernel against its plain version; raises
    beyond its tolerance (see the module docstring)."""
    import torch
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    max_abs = float(diff.max())
    scale = float(want.abs().max())
    if inst.startswith("mxu_fir.bf16"):
        rel = float(diff.norm() / want.norm())
        ok = (rel <= PROBE_BF16_TOL[0]
              and max_abs <= PROBE_BF16_TOL[1] * max(1.0, scale))
        shown = f"rel L2 {rel:.3e}"
    else:  # atol / rtol on values divided by the largest |plain value|
        ok = bool(torch.all(diff / scale <= ATOL + RTOL * want.abs() / scale))
        shown = f"max abs / max |plain| {max_abs / scale:.3e}"
    print(f"  {inst} ({case}): max_abs {max_abs:.3e}, {shown} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{inst} at {case} disagrees with its plain "
                             "version")
    return max_abs


def probe_phase(peaks) -> tuple[dict, dict]:
    """Phase M (see the module docstring). Returns ({instance: its record
    for the ``kernels`` line, with per-case rows}, the drive run's
    counts)."""
    from flowhigh_tpu_torch import ops

    bench = _load_probe_script()
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    records = bench.run(REPS, WARMUP,
                        emit=lambda line: print(f"  {line}", flush=True))
    counts = probe_counts()
    print(f"phase M: probe script run ({len(records)} cases) in "
          f"{time.perf_counter() - t0:.1f} s; launches {counts}", flush=True)
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel of the probe path did not run: "
                             f"{counts}")

    rng = np.random.default_rng(0)  # the script's inputs, drawn again
    res = {inst: {"launches": counts[inst], "cases": []}
           for inst in PROBE_ROWS}
    for rec, (name, s, c, p) in zip(records, bench.CASES):
        inp = bench.case_inputs(rng, s, c, p, "cuda")
        rows = bench.case_rows(inp, s, c, p, peaks)
        for inst, row in PROBE_ROWS.items():
            if row not in rows:
                continue
            run, plain, bound_ms, bound_by = rows[row]
            err = _compare_probe(inst, name, run(), plain())
            res[inst]["cases"].append({
                "case": name, "ms": rec["rows"][row]["ms"],
                "plain_ms": time_ms(plain), "bound_ms": bound_ms,
                "bound_by": bound_by, "max_abs_err": err,
                "kernel_a_ms": rec["rows"]["act_full"]["ms"],
                "kernel_b_ms": rec["rows"]["conv k7d3"]["ms"],
                **({"bound_fma_ms": rec["rows"][row]["bound_fma_ms"]}
                   if "bound_fma_ms" in rec["rows"][row] else {})})
        del inp, rows
    for inst, r in res.items():
        cs = r["cases"]
        r.update({f: sum(x[f] for x in cs) for f in
                  ("ms", "plain_ms", "bound_ms", "kernel_a_ms",
                   "kernel_b_ms")})
        r["bound_by"] = max(cs, key=lambda x: x["bound_ms"])["bound_by"]
        r["max_abs_err"] = max(x["max_abs_err"] for x in cs)
        r["library_ms"] = None
        r["unfused_chain_ms"] = None
        fma = ""
        if all("bound_fma_ms" in x for x in cs):  # H f32: 3xTF32 and FMA
            r["bound_fma_ms"] = sum(x["bound_fma_ms"] for x in cs)
            fma = f" in 3xTF32, {r['bound_fma_ms']:.3f} at the f32 FMA peak"
        print(f"  {inst}: {r['launches']} launches; one per case: "
              f"{r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound "
              f"{r['bound_ms']:.3f} {r['bound_by']}{fma}; kernel A "
              f"{r['kernel_a_ms']:.3f}, B {r['kernel_b_ms']:.3f} on the same "
              f"elements)", flush=True)
    print(f"phase M: done in {time.perf_counter() - t0:.1f} s", flush=True)
    return res, counts


CLI_SOLVER = ["--time_step", "1", "--ode_method", "euler",
              "--cfm_method", "independent_cfm_adaptive"]


def cli_phase(sr, audio: np.ndarray, calls: dict) -> dict:
    """Phase I (see the module docstring). ``sr`` is phase 2's model,
    ``audio`` its 10 s signal, ``calls`` its path's calls."""
    import shutil

    import scipy.io.wavfile as wavfile

    from flowhigh_tpu_torch import cli, ops
    from flowhigh_tpu_torch.config import VocoderConfig
    from flowhigh_tpu_torch.models import BigVGAN
    from flowhigh_tpu_torch.profiling import clip_signal

    work_dir = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(work_dir, ignore_errors=True)
    work_dir.mkdir(parents=True)

    def pcm(x):
        return np.round(np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)

    def as_written(out):  # the CLI's write: clip, x 32767, int16
        return (np.clip(out[0], -1, 1) * 32767).astype(np.int16).astype(int)

    def read(path):
        rate, data = wavfile.read(path)
        if rate != 48000 or data.dtype != np.int16:
            raise AssertionError(f"{path}: {rate} Hz {data.dtype}")
        return data.astype(int)

    def cli_run(what, argv):
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"phase I: {what}: exit code {rc}")
        return wall

    res: dict = {}
    # infer --input, 10 s
    a16 = pcm(audio)
    wavfile.write(work_dir / "in10.wav", IN_SR, a16)
    want = as_written(sr.generate(a16, IN_SR, timestep=1))
    ops.reset_launch_counts()
    wall = cli_run("infer --input", [
        "infer", "--input", str(work_dir / "in10.wav"), "--output",
        str(work_dir / "out10.wav")] + CLI_SOLVER)
    counts = launch_counts()
    got = read(work_dir / "out10.wav")
    d = int(np.abs(got - want).max()) if got.shape == want.shape else None
    print(f"phase I: cli infer --input 10 s: {wall:.2f} s wall (model build "
          f"included); output vs phase 2's model's generate on the same "
          f"samples: max {d} int16 steps (<= 1)", flush=True)
    if d is None or d > 1:
        raise AssertionError(f"phase I: cli infer differs from generate: {d}")
    check_launches("phase I: cli infer --input", counts, calls)
    res["infer_input"] = {"wall_s": wall, "max_steps_vs_generate": d,
                          "launches": counts}

    # infer --input_dir, three wavs, int16 wire
    in_dir = work_dir / "wavs"
    in_dir.mkdir()
    clips = [(16000, 2.0, 0.8), (8000, 3.0, 0.6), (16000, 1.5, 0.5)]
    for i, (rate, sec, gain) in enumerate(clips):
        wavfile.write(in_dir / f"clip{i}.wav", rate,
                      pcm(clip_signal(sec, rate) * np.float32(gain)))
    wall = cli_run("infer --input_dir", [
        "infer", "--input_dir", str(in_dir), "--output_dir",
        str(work_dir / "out"), "--wire", "int16"] + CLI_SOLVER)
    steps = []
    for i, (rate, sec, _) in enumerate(clips):
        got = read(work_dir / "out" / f"clip{i}_48k.wav")
        want = as_written(sr.generate(
            wavfile.read(in_dir / f"clip{i}.wav")[1], rate, timestep=1))
        steps.append(int(np.abs(got - want).max())
                     if got.shape == want.shape else None)
    print(f"phase I: cli infer --input_dir (3 wavs, 16 and 8 kHz, int16 "
          f"wire): {wall:.2f} s wall; each vs generate: {steps} int16 steps "
          f"(<= 1)", flush=True)
    if any(d is None or d > 1 for d in steps):
        raise AssertionError(f"phase I: --input_dir differs: {steps}")
    res["infer_input_dir"] = {"wall_s": wall, "max_steps_vs_generate": steps}

    # vocoder, 1 s at 48 kHz, random weights at full width
    voc_dir = work_dir / "voc"
    voc_dir.mkdir()
    wavfile.write(voc_dir / "a.wav", 48000, pcm(clip_signal(1.0, 48000)))
    ops.reset_launch_counts()
    wall = cli_run("vocoder", ["vocoder", "--input_dir", str(voc_dir),
                               "--output_dir", str(work_dir / "voc_out")])
    counts = launch_counts()
    got = read(work_dir / "voc_out" / "a_generated.wav")
    print(f"phase I: cli vocoder 1 s at 48 kHz: {wall:.2f} s wall, "
          f"{len(got)} samples", flush=True)
    if len(got) != 48000:
        raise AssertionError(f"phase I: vocoder output {got.shape}")
    check_launches("phase I: cli vocoder", counts,
                   main_path_calls(VocoderConfig(), 48000 // 480))
    res["vocoder"] = {"wall_s": wall, "launches": counts}

    # --tiny: kernel C at its even upsamplers, the library at its odd ones
    wavfile.write(work_dir / "in1.wav", IN_SR, pcm(clip_signal(1.0, IN_SR)))
    tiny = ["infer", "--input", str(work_dir / "in1.wav"), "--tiny"]
    ops.reset_launch_counts()
    BigVGAN.library_upsamplers = 0
    cli_run("infer --tiny", tiny + ["--output", str(work_dir / "tiny.wav")]
            + CLI_SOLVER)
    n_c, n_lib = ops.conv_transpose1d.launches, BigVGAN.library_upsamplers
    cli_run("infer --tiny --device cpu", tiny + [
        "--output", str(work_dir / "tiny_cpu.wav"), "--device", "cpu"]
        + CLI_SOLVER)
    got, want = read(work_dir / "tiny.wav"), read(work_dir / "tiny_cpu.wav")
    d = int(np.abs(got - want).max()) if got.shape == want.shape else None
    print(f"phase I: cli infer --tiny: upsamplers on kernel C {n_c} "
          f"((8, 16), (4, 8)), on the library conv {n_lib} ((5, 10), "
          f"(3, 6)); card vs CPU max {d} int16 steps (<= 33, 1e-3)",
          flush=True)
    if n_c != 2 or n_lib != 2 or d is None or d > 33:
        raise AssertionError(f"phase I: --tiny: C {n_c}, library {n_lib}, "
                             f"card vs CPU {d}")
    res["tiny"] = {"kernel_c": n_c, "library_upsamplers": n_lib,
                   "card_vs_cpu_steps": d}
    shutil.rmtree(work_dir, ignore_errors=True)
    return res


SOURCES = {
    "snake_aa": ("flowhigh_tpu_torch/csrc/snake_aa.cu",
                 "flowhigh_tpu/ops/fused_act.py:193, flowhigh_tpu/ops/packed.py:749"),
    "conv1d_same": ("flowhigh_tpu_torch/csrc/conv1d_same.cu",
                    "flowhigh_tpu/ops/packed.py:361 (pallas_packed_conv1d)"),
    "conv_transpose1d": ("flowhigh_tpu_torch/csrc/conv_transpose1d.cu",
                         "flowhigh_tpu/ops/packed.py:361 "
                         "(pallas_packed_conv_transpose1d)"),
    "act_conv1d": ("flowhigh_tpu_torch/csrc/act_conv1d.cu",
                   "flowhigh_tpu/ops/packed.py:1043 (pallas_packed_act_conv1d)"),
    "amp_unit": ("flowhigh_tpu_torch/csrc/amp_unit.cu",
                 "flowhigh_tpu/ops/packed.py:1362 (pallas_packed_amp_unit)"),
    FLASH: ("flowhigh_tpu_torch/csrc/flash_attn.cu",
            "flowhigh_tpu/models/transformer.py:150 (_flash_attention, "
            ":120, the Pallas TPU flash_attention kernel)"),
}
for _v in VARIANT_NAMES:  # each variant: its kernel's source and dot_dtype
    _base, _, _sfx = _v.partition(".")
    SOURCES[_v] = (SOURCES[_base][0], SOURCES[_base][1].replace(
        ")", f", dot_dtype={SUFFIXES[_sfx]})"))
for _v in STORAGE_NAMES:  # on bf16 maps: storage_dtype bf16 (C: dtype bf16)
    _src, _rep = SOURCES[_v.partition("@")[0]]
    SOURCES[_v] = (_src, _rep + (
        "; bf16 x and output (flowhigh_tpu/models/bigvgan.py:460-463, "
        "dtype=bfloat16)" if _v in CONVT_BF16_MAPS else
        "; bf16 x, residuals and output "
        "(flowhigh_tpu/models/bigvgan.py:404 storage_dtype)"))
_H = ("flowhigh_tpu_torch/csrc/probe_fir.cu",
      "scripts/bench_act_mxu.py:102 (mxu_fir")
SOURCES.update({
    "snake_aa.firs": ("flowhigh_tpu_torch/csrc/snake_aa.cu",
                      "scripts/bench_act_mxu.py:147-150 (firs_only: "
                      "flowhigh_tpu/ops/packed.py:749 with _snake_packed "
                      "as the identity)"),
    "snake_only": ("flowhigh_tpu_torch/csrc/probe_snake.cu",
                   "scripts/bench_act_mxu.py:52 (snake_only)"),
    "mxu_fir": (_H[0], _H[1] + ", float32)"),
    "mxu_fir.dots": (_H[0], _H[1] + ", float32, do_snake=False)"),
    "mxu_fir.bf16": (_H[0], _H[1] + ", bfloat16)"),
    "mxu_fir.bf16_dots": (_H[0], _H[1] + ", bfloat16, do_snake=False)"),
})
RECORD = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
          "unfused_chain_ms", "max_abs_err", "launches")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "flowhigh_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: flowhigh_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from flowhigh_tpu_torch import FlowHighConfig
    from flowhigh_tpu_torch.ops import _build
    from flowhigh_tpu_torch.profiling import clip_signal

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    t_start = time.perf_counter()

    # phase 0: the card and the build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = card.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    clock_mhz = sm_clock_mhz()
    print(f"card: {card}; peaks used for bounds: {peaks[0] / 1e12:g} TFLOP/s "
          f"f32, {peaks[1] / 1e12:g} TB/s, {peaks[4] / 1e12:g} TFLOP/s TF32",
          flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 0: built {len(libs)} kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    spilled, convt_spills = [], {}
    for lib_name, path in libs.items():
        log = path.with_suffix(".log")
        for kern, args, regs, spill in ptxas_entries(
                log.read_text() if log.exists() else ""):
            print(f"  {lib_name}: {kern}<{args}> {regs} registers, spill "
                  f"{spill[0]} / {spill[1]} bytes")
            if kern in NO_SPILL and spill != (0, 0):
                spilled.append(f"{kern}<{args}>")
            if kern == "conv_transpose1d_kernel":  # <Dot, Store, U, K>
                convt_spills[f"{lib_name}<{args}>"] = (regs,) + spill
    # kernel C stays outside NO_SPILL: its spills, f32 and bf16 maps
    print(f"phase 0: kernel C (registers, spill stores, spill loads) by "
          f"<Dot, Store, U, K>: {convt_spills}", flush=True)
    if spilled:  # the s8 instances and D and E's tensor-core ones must not
        raise AssertionError(f"ptxas spills in {spilled}")

    config = FlowHighConfig()
    frames = int(SECONDS * 48000) // config.mel.hop_length
    calls = main_path_calls(config.vocoder, frames)
    calls_unfused = main_path_calls(config.vocoder, frames, False)
    long_frames = int(LONG_SECONDS * 48000) // config.mel.hop_length
    calls_long = longform_calls(config.vocoder, long_frames)
    # the reduced-precision paths: {dtype name: (fused calls, unfused calls)}
    calls_red = {n: tuple(main_path_calls(config.vocoder, frames, fuse,
                                          getattr(torch, n))
                          for fuse in (True, False)) for n in REDUCED}
    # the bf16-map paths: {dot dtype name: (fused calls, unfused calls)}
    calls_sto = {n: tuple(main_path_calls(
        config.vocoder, frames, fuse,
        None if n == "float32" else getattr(torch, n), torch.bfloat16)
        for fuse in (True, False)) for n in STORAGE_DOTS}
    # phase X's bf16-compute paths (fused): {dot dtype name: calls}
    calls_cmp = {n: main_path_calls(
        config.vocoder, frames, True,
        None if n == "float32" else getattr(torch, n), None, torch.bfloat16)
        for n in COMPUTE_DOTS}
    # phase S3's AMPBlock2 vocoder at the published widths
    calls_rb2 = main_path_calls(
        dataclasses.replace(config.vocoder, **RESBLOCK2), frames)

    # phase 1: kernels against plain versions at every shape of the paths
    t0 = time.perf_counter()
    shapes = {k: set(calls[k]) | set(calls_unfused[k]) | set(calls_long[k])
              | set(calls_rb2[k]) for k in KERNEL_NAMES}
    for v in VARIANT_NAMES:
        shapes[v] = set().union(*(set(c.get(v, ())) for pair in
                                  calls_red.values() for c in pair))
    for v in STORAGE_NAMES:
        shapes[v] = set().union(*(set(c.get(v, ())) for pair in
                                  calls_sto.values() for c in pair),
                                *(set(c.get(v, ()))
                                  for c in calls_cmp.values()))
    rows = check_kernels(shapes, "cuda", peaks)
    cmp_tot = {n: path_totals(c, rows) for n, c in calls_cmp.items()}
    sto_tot = {n: tuple(path_totals(c, rows) for c in pair)
               for n, pair in calls_sto.items()}
    for n, (fused_t, unfused_t) in sto_tot.items():
        for k in STORAGE_NAMES:
            for what, r in (("fused", fused_t.get(k)),
                            ("unfused", unfused_t.get(k))):
                if r is None:
                    continue
                print(f"  {k} (bf16 maps, {n} dots, {what} path): "
                      f"{r['launches']} launches, {r['ms']:.2f} ms per clip "
                      f"(float32-map instance {r['f32_ms']:.2f}, plain "
                      f"{r['plain_ms']:.2f}, bound {r['bound_ms']:.3f} "
                      f"{r['bound_by']}, library {r['library_ms']}, unfused "
                      f"chain {r['unfused_chain_ms']}), max abs err "
                      f"{r['max_abs_err']:.2e}", flush=True)
    main_tot = path_totals(calls, rows)
    unfused_tot = path_totals(calls_unfused, rows)
    rb2_tot = path_totals(calls_rb2, rows)
    red_tot = {n: tuple(path_totals(c, rows) for c in pair)
               for n, pair in calls_red.items()}
    for n, (fused_t, unfused_t) in red_tot.items():
        for k in VARIANT_NAMES:
            r = fused_t.get(k) or unfused_t.get(k)
            if r is None:
                continue
            print(f"  {k} ({n} {'fused' if k in fused_t else 'unfused'} "
                  f"path): {r['launches']} launches, {r['ms']:.2f} ms per "
                  f"clip (f32 instance {r['f32_ms']:.2f}, plain "
                  f"{r['plain_ms']:.2f}, bound {r['bound_ms']:.3f} "
                  f"{r['bound_by']}, library {r['library_ms']}, unfused "
                  f"chain {r['unfused_chain_ms']}), max abs err "
                  f"{r['max_abs_err']:.2e}", flush=True)
    print(f"phase 1: {sum(len(v) for v in shapes.values())} vocoder shapes "
          f"checked and timed in {time.perf_counter() - t0:.1f} s", flush=True)
    for k, r in main_tot.items():
        print(f"  {k}: {r['launches']} launches, {r['ms']:.2f} ms per clip "
              f"(plain {r['plain_ms']:.2f}, bound {r['bound_ms']:.2f} "
              f"{r['bound_by']}, library {r['library_ms']}, unfused chain "
              f"{r['unfused_chain_ms']}), max abs err {r['max_abs_err']:.2e}",
              flush=True)
    for k, tot in (("conv_transpose1d", main_tot),
                   ("conv_transpose1d.bf16", red_tot["bfloat16"][0]),
                   ("conv_transpose1d@bf16", cmp_tot["float32"]),
                   ("conv_transpose1d.bf16@bf16", cmp_tot["bfloat16"])):
        for r in tot[k]["shapes"]:  # kernel C per upsampler of the clip
            lib = ("none" if r["library_ms"] is None
                   else f"{r['library_ms']:.3f}")
            f32 = f", float32-map {r['f32_ms']:.3f}" if "f32_ms" in r else ""
            print(f"  {k} {tuple(r['key'])}: {r['ms']:.3f} ms (plain "
                  f"{r['plain_ms']:.3f}, library {lib}{f32}, "
                  f"bound {max(r['bytes_ms'], r['ops_ms']):.3f} "
                  f"{'bytes' if r['bytes_ms'] >= r['ops_ms'] else 'ops'}), "
                  f"max abs err {r['max_abs_err']:.2e}", flush=True)
    for k, tot in (("conv1d_same", unfused_tot),
                   ("conv1d_same.bf16", red_tot["bfloat16"][1]),
                   ("conv1d_same.int8", red_tot["int8"][1])):
        print_conv_rows(k, tot[k])
    for k in ("conv1d_same.int8", "conv1d_same.int8@bf16"):
        b8 = max(r["max_abs_err"] for r in rows[k].values())
        print(f"  {k}: max abs against its plain version {b8:.3e} over "
              f"{len(rows[k])} shapes (expected 0.0)", flush=True)
        if b8 != 0.0:  # exact int32 sums, the plain version's quanta, order
            raise AssertionError(f"{k} differs from its plain version: max "
                                 f"abs {b8}")
    t0 = time.perf_counter()
    flash_rows = check_flash(peaks, long_frames)
    print(f"phase 1: flash_attn checked and timed at {len(flash_rows)} shapes "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase M: the probe kernels on the probe script's path
    probes, probe_launches = probe_phase(peaks)

    # phase 2: full width, 10 s clip, default path then unfused path
    sr = make_sr(config, "cuda")
    audio = clip_signal(SECONDS, IN_SR)
    out, counts = run_main_path(sr, audio, IN_SR)
    torch.cuda.synchronize()
    print(f"phase 2: default path: out {out.shape} "
          f"finite={bool(np.isfinite(out).all())}", flush=True)
    if out.shape != (1, int(SECONDS * 48000)) or not np.isfinite(out).all():
        raise AssertionError(f"bad output {out.shape}")
    check_launches("phase 2: default path", counts, calls)
    if min(counts[k] for k in KERNEL_NAMES) == 0:
        raise AssertionError(f"a kernel did not run on the main path: {counts}")
    times = clip_ms_of(sr, audio)
    clip_ms = float(np.median(times))
    print(f"phase 2: default path {clip_ms:.2f} ms per 10 s clip (median of "
          f"5: {[round(t, 2) for t in times]}), RTF "
          f"{SECONDS * 1e3 / clip_ms:.1f}", flush=True)

    mel10 = vocoder_mel(sr, audio)  # phase X's mel

    sr_unf = make_sr(config, "cuda", fuse_act_conv=False)
    out_unf, counts_unf = run_main_path(sr_unf, audio, IN_SR)
    check_launches("phase 2: unfused path", counts_unf, calls_unfused)
    with snake_arguments([]) as sine_args:
        sr_unf.generate(audio, IN_SR, timestep=1)
    print(f"phase 2: kernel A's sine argument |a u| on the unfused path: "
          f"largest {max(sine_args):.4g} over {len(sine_args)} calls (the "
          f"error bound of csrc/snake.cuh holds to {2.0 ** 15:g})",
          flush=True)
    if not max(sine_args) <= 2.0 ** 15:
        raise AssertionError(f"|a u| reached {max(sine_args)}, beyond the "
                             "sine's stated range")
    times_unf = clip_ms_of(sr_unf, audio)
    clip_ms_unf = float(np.median(times_unf))
    paths_diff = float(np.abs(out - out_unf).max())
    print(f"phase 2: unfused path {clip_ms_unf:.2f} ms per 10 s clip (median "
          f"of 5: {[round(t, 2) for t in times_unf]}), RTF "
          f"{SECONDS * 1e3 / clip_ms_unf:.1f}; default vs unfused output max "
          f"abs diff {paths_diff:.3e}", flush=True)
    del sr_unf
    if not paths_diff <= 1e-3:
        raise AssertionError(f"default and unfused paths disagree: {paths_diff}")

    # serving phase
    serving = serving_phase(sr)

    # phase I: the CLI on the card
    t0 = time.perf_counter()
    cli_res = cli_phase(sr, audio, calls)
    print(f"phase I: done in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 3: 1 s clip, card vs CPU plain path, same weights
    short = clip_signal(1.0, IN_SR)
    out_gpu = sr.generate(short, IN_SR, timestep=1)
    t0 = time.perf_counter()
    sr_cpu = make_sr(config, "cpu")
    out_cpu = sr_cpu.generate(short, IN_SR, timestep=1)
    diff = float(np.abs(out_gpu - out_cpu).max())
    print(f"phase 3: 1 s clip card vs CPU max abs diff {diff:.3e}, rel L2 "
          f"{rel_l2(out_gpu, out_cpu):.3e} "
          f"(CPU run {time.perf_counter() - t0:.1f} s)", flush=True)
    stages = stage_diffs(sr, sr_cpu, short)
    print(f"phase 3: where card and CPU part: {stages}", flush=True)
    del sr, sr_cpu
    if out_gpu.shape != out_cpu.shape or not diff <= 1e-3:
        raise AssertionError(f"card and CPU disagree: {diff}")

    # phase P: the reduced-precision vocoder, and phase 3 at each dtype
    t0 = time.perf_counter()
    reduced = reduced_phase(config, frames, out, audio, (out_gpu, out_cpu))
    print(f"phase P: done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    storage = storage_phase(config, frames, out, audio, (out_gpu, out_cpu))
    print(f"phase P (bf16 maps): done in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phase X: the vocoder's compute dtype bf16 (MelVoco(dtype=bfloat16))
    t0 = time.perf_counter()
    compute = compute_phase(config, mel10)
    compute["phase_s"] = time.perf_counter() - t0
    del mel10
    print(f"phase X: done in {compute['phase_s']:.1f} s", flush=True)

    # phase L: long-form, single pass and streamed
    longform = longform_phase(config, out, audio)
    long_tot = path_totals(calls_long, rows)
    r = flash_rows[(1, long_frames, long_frames)]
    n_f = longform["launches"][FLASH]
    long_tot[FLASH] = {
        "launches": n_f,
        "max_abs_err": max(x["max_abs_err"] for x in flash_rows.values()),
        "bound_ms": n_f * max(r["bytes_ms"], r["ops_ms"]),
        "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
        "ms": n_f * r["ms"], "plain_ms": n_f * r["plain_ms"],
        "library_ms": n_f * r["library_ms"], "unfused_chain_ms": None}

    # phase S: the adaptive solver, sample(), AMPBlock2, the front end
    t0 = time.perf_counter()
    surface = surface_phase(config, calls, audio)
    print(f"phase S: done in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase V: the vector field's options
    t0 = time.perf_counter()
    options = options_phase(config, calls, audio, out, peaks)
    print(f"phase V: done in {time.perf_counter() - t0:.1f} s", flush=True)

    # phase T: the vector field's trainer
    t0 = time.perf_counter()
    training = train_phase(config, peaks)
    training["phase_s"] = time.perf_counter() - t0
    print(f"phase T: done in {training['phase_s']:.1f} s", flush=True)

    # phase D: the data pipeline, the device sosfiltfilt, the CLI's train
    t0 = time.perf_counter()
    data = data_phase(config, peaks, clock_mhz)
    data["phase_s"] = time.perf_counter() - t0
    print(f"phase D: done in {data['phase_s']:.1f} s", flush=True)

    # phase W: the vocoder's GAN training
    t0 = time.perf_counter()
    gan = gan_phase(config)
    gan["phase_s"] = time.perf_counter() - t0
    print(f"phase W: done in {gan['phase_s']:.1f} s", flush=True)

    # phase 4: the records
    kernels = []
    for k in ALL_KERNELS:
        src, replaces = SOURCES[k]
        r = main_tot.get(k, long_tot[k])
        entry = {"name": k, "route": "cuda", "source": src,
                 "replaces": replaces, **{f: r[f] for f in RECORD}}
        if k in unfused_tot:
            entry["unfused_path"] = {f: unfused_tot[k][f] for f in RECORD}
        if k in main_tot:
            entry["longform_path"] = {f: long_tot[k][f] for f in RECORD}
        if k in rb2_tot:
            entry["resblock2_path"] = {f: rb2_tot[k][f] for f in RECORD}
        if k in gan["w2"]:  # phase W2: under autograd, per GAN step
            entry["gan_train_path"] = gan["w2"][k]
        if k == FLASH:  # phase T3: Trainer.evaluate with attn_flash=True
            r3 = training["t3"]["flash"]
            entry["evaluate_launches"] = r3["launches"]
            entry["evaluate_path"] = {f: r3[f] for f in RECORD}
        kernels.append(entry)
    for k in VARIANT_NAMES:  # each on its dtype's fused path, else unfused
        n = SUFFIXES[k.partition(".")[2]]
        fused_t, unfused_t = red_tot[n]
        r = fused_t.get(k) or unfused_t[k]
        src, replaces = SOURCES[k]
        entry = {"name": k, "route": "cuda", "source": src,
                 "replaces": replaces, **{f: r[f] for f in RECORD},
                 "f32_ms": r["f32_ms"],
                 "path": f"vocoder_conv_dtype={n}, "
                         f"fuse_act_conv={k in fused_t}"}
        if k in fused_t and k in unfused_t:
            entry["unfused_path"] = {f: unfused_t[k][f]
                                     for f in RECORD + ("f32_ms",)}
        kernels.append(entry)
    for k in CONVT_BF16_MAPS:  # on phase X's bf16-compute path of its dots
        n = SUFFIXES.get(split_name(k)[1], "float32")
        r = cmp_tot[n][k]
        src, replaces = SOURCES[k]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": replaces, **{f: r[f] for f in RECORD},
                        "f32_ms": r["f32_ms"],
                        "path": f"MelVoco(dtype=bfloat16, conv_dtype={n}, "
                                f"fuse_act_conv=True).decode"})
    for k in STORAGE_NAMES:  # on bf16 maps: the dot's fused path, else unfused
        if k in CONVT_BF16_MAPS:
            continue
        n = SUFFIXES.get(split_name(k)[1], "float32")
        fused_t, unfused_t = sto_tot[n]
        r = fused_t.get(k) or unfused_t[k]
        src, replaces = SOURCES[k]
        entry = {"name": k, "route": "cuda", "source": src,
                 "replaces": replaces, **{f: r[f] for f in RECORD},
                 "f32_ms": r["f32_ms"],
                 "path": f"vocoder_storage_dtype=bfloat16, "
                         f"vocoder_conv_dtype={n}, "
                         f"fuse_act_conv={k in fused_t}"}
        if k in fused_t and k in unfused_t:
            entry["unfused_path"] = {f: unfused_t[k][f]
                                     for f in RECORD + ("f32_ms",)}
        kernels.append(entry)
    r = options["flash_registers"]  # phase V2's flash run, per clip
    src, replaces = SOURCES[FLASH]
    kernels.append({"name": FLASH_REGISTERS, "route": "cuda", "source": src,
                    "replaces": replaces + "; on register-padded q, k, v "
                    "and mask (flowhigh_tpu/models/transformer.py:318-319)",
                    **{f: r[f] for f in RECORD},
                    "path": "ModelConfig(num_register_tokens=16, "
                            "use_unet_skip_connection=True, "
                            "use_gateloop_layers=True, attn_flash=True)"})
    for k, r in probes.items():  # phase M's run; ms etc. one per case
        src, replaces = SOURCES[k]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": replaces, **{f: r[f] for f in RECORD},
                        "path": "scripts/port_bench_act_mxu.py (probe)",
                        "kernel_a_ms": r["kernel_a_ms"],
                        "kernel_b_ms": r["kernel_b_ms"]})
    r = data["d3"]  # phase D3: the device sosfiltfilt on a batch's crops
    kernels.append({"name": SOSFILT, "route": "cuda",
                    "source": "flowhigh_tpu_torch/csrc/sosfilt.cu",
                    "replaces": "flowhigh_tpu/dsp/filters.py:97 (_sosfilt, "
                                "a lax.scan; no pallas_call)",
                    **{f: r[f] for f in RECORD},
                    "path": f"dsp.sosfiltfilt on {list(D3_BATCH)} (order "
                            f"{D3_FILTERS[-1][0]}); times on {r['shape']}",
                    "shape": r["shape"],
                    "serial_bound_ms": r["serial_bound_ms"],
                    "crop": r["crop"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "torch": torch.__version__, "seconds": SECONDS,
        "clip_ms": clip_ms, "clip_ms_all": times,
        "rtf": SECONDS * 1e3 / clip_ms, "clip_ms_unfused": clip_ms_unf,
        "clip_ms_unfused_all": times_unf, "paths_max_abs_diff": paths_diff,
        "sine_argument_max": max(sine_args),
        "serving": serving, "phase3_max_abs_diff": diff,
        "phase3_stages": stages, "launches": counts,
        "launches_unfused": counts_unf, "main_path": main_tot,
        "unfused_path": unfused_tot, "reduced": reduced,
        "reduced_paths": {n: {"fused": f, "unfused": u}
                          for n, (f, u) in red_tot.items()},
        "storage": storage,
        "storage_paths": {n: {"fused": f, "unfused": u}
                          for n, (f, u) in sto_tot.items()},
        "compute": compute, "compute_paths": cmp_tot,
        "convt_ptxas": convt_spills,
        "longform": longform,
        "longform_path": long_tot,
        "flash_rows": {str(k): v for k, v in flash_rows.items()},
        "probes": probes, "probe_launches": probe_launches, "cli": cli_res,
        "surface": surface, "resblock2_path": rb2_tot, "options": options,
        "train": training, "data": data, "gan": gan,
        "script_s": time.perf_counter() - t_start}, indent=1, default=str))
    train_paths = [{"name": f"Trainer.train_step, batch "
                            f"{config.train.batch_size}, "
                            f"amp_dtype={amp}",
                    "launches": training[amp]["kernel_launches"],
                    "ms": training[amp]["ms_per_update"]}
                   for amp in ("bfloat16", "float32")]
    d4 = data["d4"]
    data_paths = [
        {"name": f"cli train, batch {config.train.batch_size}, "
                 f"device_prefetch (updates 2-{D4_UPDATES})",
         "launches": d4[f"steps_{D4_UPDATES}"]["kernel_launches"],
         "ms": float(np.median(d4[f"steps_{D4_UPDATES}"]["ms_per_update"])),
         "wait_share": d4[f"steps_{D4_UPDATES}"]["wait_share"]},
        {"name": "Trainer.fit on the same iterator, device_prefetch=False",
         "launches": {},
         "ms": float(np.median(d4["no_prefetch"]["ms_per_update"])),
         "wait_share": d4["no_prefetch"]["wait_share"]},
        {"name": f"dsp.sosfiltfilt on {list(D3_BATCH)}",
         "launches": {SOSFILT: r["launches"]}, "ms": r["crop"]["ms"]}]
    data_paths += [{"name": f"batch_iterator, {d['worker_type']} x "
                            f"{d['num_workers']}, batch "
                            f"{config.train.batch_size} of 3 s",
                    "launches": {}, "ms": d["ms_per_batch"],
                    "clips_per_s": d["clips_per_s"]}
                   for d in data["d2"] if "ms_per_batch" in d]
    w3 = gan["w3"]
    gan_paths = [{"name": f"VocoderTrainer.train_step, VocoderConfig(), "
                          f"batch {W_BATCH} x {W_FRAMES} frames",
                  "launches": w3["launches"], "ms": w3["ms_per_step"],
                  "peak_gib": w3["peak_gib"]}]
    print(json.dumps({"kernels": kernels,
                      "paths": surface["paths"] + options["paths"]
                      + train_paths + data_paths + gan_paths}))
    t1 = training["t1"]
    print(json.dumps({"train": {
        "t1_card_vs_cpu": {k: t1[k] for k in ("loss_rel", "grad_rel_l2",
                                              "param_rel_l2")},
        **{f"t2_{amp}": {k: training[amp][k] for k in (
            "ms_per_update", "peak_gib", "host_launches", "device_kernels")}
           for amp in ("bfloat16", "float32")},
        "t3_valid_loss_rel": training["t3"]["rel"],
        "phase_s": training["phase_s"],
        "script_s": time.perf_counter() - t_start}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
