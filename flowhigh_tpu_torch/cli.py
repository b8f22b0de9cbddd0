"""Command-line interface of the port — counterpart of
``flowhigh_tpu/cli.py``, with the same subcommands and flags plus
``--device`` (``cuda``, the default, raises without a card; ``cpu`` runs
the plain PyTorch path).

Usage:
    python -m flowhigh_tpu_torch.cli infer   --input in.wav --output out.wav ...
    python -m flowhigh_tpu_torch.cli infer   --input_dir wavs/ --output_dir out/ ...
    python -m flowhigh_tpu_torch.cli vocoder --input_dir wavs/ --output_dir out/ ...
    python -m flowhigh_tpu_torch.cli train   --config config.json --steps N ...

``infer`` runs the whole clip pipeline (the vocoder on kernels A-E on the
card); ``vocoder`` runs BigVGAN alone on the mels of 48 kHz wavs. Without
``--ckpt_dir`` / ``--checkpoint`` both run seeded random weights (smoke
mode). ``train`` trains the vector field (``train.Trainer``) on the
reference config's corpus, or on a synthetic one when its ``data_path`` is
missing, degraded on host threads and uploaded to the card ahead of each
step; ``--resume`` starts from a checkpoint's weights, otherwise it
resumes from the newest ``trainstate_*.pt`` of the results folder.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def _write_wav(path, sr, audio: np.ndarray):
    import scipy.io.wavfile as wavfile
    audio = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sr, (audio * 32767).astype(np.int16))


def tiny_config(n_layers: int = 2, architecture: str = "transformer"):
    """The ``--tiny`` smoke configuration (the JAX CLI's): a 64-wide vector
    field and a 32-channel vocoder with rates (8, 5, 4, 3) and kernels
    (16, 10, 8, 6). Its (5, 10) and (3, 6) upsamplers have an odd K - u and
    run the library transposed conv (``models/bigvgan.py``)."""
    from .config import FlowHighConfig, ModelConfig, VocoderConfig
    return FlowHighConfig().replace(
        model=ModelConfig(dim_in=256, dim=64, depth=n_layers, heads=2,
                          dim_head=16, architecture=architecture),
        vocoder=VocoderConfig(
            num_mels=256, upsample_initial_channel=32,
            upsample_rates=(8, 5, 4, 3), upsample_kernel_sizes=(16, 10, 8, 6),
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),)))


def cmd_infer(args) -> int:
    from .sr import BUCKET_SAMPLES, FlowHighSR
    from .streaming import StreamingSR
    from .train.data import load_wav_mono

    if bool(args.input_dir) == bool(args.input):
        print("[infer] give either --input/--output or --input_dir/--output_dir",
              file=sys.stderr)
        return 2
    if args.input_dir and not args.output_dir:
        print("[infer] --input_dir requires --output_dir", file=sys.stderr)
        return 2

    if args.ckpt_dir:
        model = FlowHighSR.from_local(
            args.ckpt_dir, device=args.device, model_file=args.model_file,
            cfm_method=args.cfm_method)
    else:
        print("[infer] no --ckpt_dir given: using random weights (smoke mode)")
        from .config import FlowHighConfig
        cfg = (tiny_config(args.n_layers, args.architecture) if args.tiny
               else FlowHighConfig())
        model = FlowHighSR(cfg, cfm_method=args.cfm_method,
                           ode_method=args.ode_method, sigma=args.sigma,
                           device=args.device)
        model.init_params(0)
    model.ode_method = args.ode_method
    model.sigma = args.sigma

    if args.input_dir:
        # dir-of-wavs serving through ServingPipeline: uploads, dispatch and
        # downloads of different clips overlap
        from .serving import ServingPipeline

        out_dir = Path(args.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        wavs = sorted(Path(args.input_dir).glob("*.wav"))
        if not wavs:
            print(f"[infer] no .wav files in {args.input_dir}", file=sys.stderr)
            return 2
        # mono 16-bit files ride the int16 input wire (half the upload
        # bytes, bit-identical); --no_int16_wire sends float32
        items = [(w, *load_wav_mono(w, keep_int16=not args.no_int16_wire))
                 for w in wavs]
        with ServingPipeline(model, wire=args.wire,
                             timestep=args.time_step) as srv:
            # one warm-up per (rate, bucket, input dtype) before traffic
            combos = set()
            for _, audio, sr_in in items:
                in_bucket = max(1, BUCKET_SAMPLES * sr_in // 48000)
                n_pad = max(in_bucket,
                            -(-len(audio) // in_bucket) * in_bucket)
                combos.add((sr_in, n_pad, np.dtype(audio.dtype)))
            for sr_in, n_pad, dt in sorted(
                    combos, key=lambda c: (c[0], c[1], c[2].name)):
                srv.warmup(sr_in, n_pad / sr_in, dtype=dt)
            futs = [(w, srv.submit(audio, sr_in))
                    for w, audio, sr_in in items]
            for w, f in futs:
                out = f.result()
                dest = out_dir / f"{w.stem}_48k.wav"
                _write_wav(dest, 48000, out[0])
                print(f"[infer] {w.name} -> {dest.name} "
                      f"({out.shape[-1] / 48000:.2f} s)")
        return 0

    audio, sr = load_wav_mono(args.input, keep_int16=not args.no_int16_wire)
    if args.longform == "single_pass":
        # full-context flow matching, vocoder in exact windows; build the
        # model with ModelConfig(attn_flash=True) for O(N) attention
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        out = model.generate_longform(audio, sr, timestep=args.time_step)
    elif args.streaming or args.longform == "streaming" or len(audio) > 30 * sr:
        out = StreamingSR(model).generate(audio, sr, timestep=args.time_step)
    else:
        out = model.generate(audio, sr, timestep=args.time_step)
    _write_wav(args.output, 48000, out[0])
    print(f"[infer] {args.input} ({sr} Hz) -> {args.output} (48000 Hz), "
          f"{out.shape[-1] / 48000:.2f} s")
    return 0


def cmd_train(args) -> int:
    import dataclasses

    from .config import FlowHighConfig
    from .models import VectorFieldNet
    from .parallel import initialize, make_global_mesh, shard_global_batch
    from .train import (AudioDataset, SyntheticAudioDataset, Trainer,
                        batch_iterator, random_split)
    from .utils import model_summary, resolve_device

    # a launch (torchrun --nproc_per_node=N, or its environment set by
    # hand) joins the ranks: NCCL on the card, gloo with --device cpu; one
    # process without that environment joins nothing
    proc_idx, proc_cnt = initialize(device=args.device)
    if proc_cnt > 1:
        print(f"[train] multi-process: rank {proc_idx}/{proc_cnt}")
    device = resolve_device(None if args.device == "cuda" else args.device)

    cfg = (FlowHighConfig.from_reference_json(args.config)
           if args.config else FlowHighConfig())
    if args.steps:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, num_train_steps=args.steps))

    if cfg.data.data_path and Path(cfg.data.data_path).exists():
        ds = AudioDataset(cfg.data.data_path, cfg.data)
    else:
        print("[train] data_path missing: using synthetic corpus")
        ds = SyntheticAudioDataset(cfg.data, n_items=256, seconds=3.0)

    # train/valid split (reference: trainer.py:118-129, seed 53) unless a
    # dedicated valid corpus is configured (valid_prepare analog)
    if cfg.data.valid_path and Path(cfg.data.valid_path).exists():
        train_ds = ds
        valid_ds = AudioDataset(cfg.data.valid_path, cfg.data, mode="valid")
    else:
        train_ds, valid_ds = random_split(ds, cfg.train.valid_frac,
                                          cfg.train.random_split_seed)
        print(f"[train] {len(train_ds)} train / {len(valid_ds)} valid "
              f"(random_split seed {cfg.train.random_split_seed})")

    mesh = make_global_mesh(n_model=args.tp)  # one process: 1 x 1
    trainer = Trainer(cfg, mesh=mesh, cfm_method=cfg.cfm.cfm_method,
                      results_folder=args.save_dir or cfg.train.save_dir,
                      device=device)
    if proc_idx == 0:
        # model summary at startup (reference: train.py:75 torchinfo.summary)
        print(model_summary(VectorFieldNet(trainer.model_cfg),
                            "FLowHigh vector field"))
    pad_to = cfg.data.sampling_rate * 3
    # on the card the prefetch threads upload each batch (pinned buffers, a
    # side stream), so that the copy overlaps the running step; the ranks
    # of one data index read that index's disjoint rows of each global batch
    on_card = device.type == "cuda"
    data = batch_iterator(train_ds, cfg.train.batch_size, pad_to=pad_to,
                          device_prefetch=on_card,
                          device=device if on_card else None,
                          process_index=mesh.index("data"),
                          process_count=mesh.shape["data"])
    steps = data
    if proc_cnt > 1:  # local rows -> this rank's share of each global batch
        steps = (shard_global_batch(mesh, b) for b in data)
    try:
        valid_iter = batch_iterator(valid_ds, min(cfg.train.batch_size,
                                                  max(1, len(valid_ds))),
                                    pad_to=pad_to, num_workers=1)
        try:
            valid_batches = [next(valid_iter) for _ in range(2)]
        finally:
            valid_iter.close()  # stop its prefetch threads
        state = None
        if args.resume:
            state = trainer.init_state(params=trainer.load_params(args.resume))
        trainer.fit(steps, state=state, auto_resume=not args.resume,
                    valid_batches=valid_batches)
    finally:
        data.close()  # stop the training iterator's prefetch threads
    return 0


def cmd_vocoder(args) -> int:
    import torch

    from .compat.jax_params import seeded_init_
    from .compat.torch_ckpt import (vocoder_config_from_json,
                                    vocoder_state_from_reference)
    from .config import MelConfig, VocoderConfig
    from .models import BigVGAN, mel_encode
    from .train.data import load_wav_mono
    from .utils import resolve_device

    device = resolve_device(args.device)
    cfg = vocoder_config_from_json(args.config) if args.config \
        else VocoderConfig()
    net = BigVGAN(cfg).eval()
    if args.checkpoint:
        pkg = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
        net.load_state_dict(vocoder_state_from_reference(
            pkg.get("generator", pkg), net.state_dict()))
    else:
        print("[vocoder] no --checkpoint: random weights (smoke mode)")
        seeded_init_(net, 0)
    net.to(device)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for wav in sorted(Path(args.input_dir).glob("*.wav")):
        audio, sr = load_wav_mono(wav)
        if sr != 48000:
            raise ValueError(f"{wav}: vocoder expects 48 kHz input, got {sr}")
        with torch.inference_mode():
            mel = mel_encode(torch.from_numpy(audio)[None].to(device),
                             MelConfig())
            y = net(mel)[0].cpu().numpy()
        _write_wav(out_dir / f"{wav.stem}_generated.wav", 48000, y)
        print(f"[vocoder] {wav.name} -> {wav.stem}_generated.wav")
    return 0


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default; raises without a card) or cpu "
                        "(the plain PyTorch path)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="flowhigh_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("infer", help="file-to-file super-resolution")
    pi.add_argument("--input", default=None)
    pi.add_argument("--output", default=None)
    pi.add_argument("--input_dir", default=None,
                    help="serve every .wav in a directory through the "
                         "pipelined ServingPipeline (overlapped transfers)")
    pi.add_argument("--output_dir", default=None)
    pi.add_argument("--wire", default="float32", choices=["float32", "int16"],
                    help="device->host download format for --input_dir mode")
    pi.add_argument("--no_int16_wire", action="store_true",
                    help="upload mono 16-bit wavs as float32 instead of "
                         "the raw-int16 input wire (both --input and "
                         "--input_dir modes)")
    pi.add_argument("--ckpt_dir", default=None)
    pi.add_argument("--model_file", default="FLowHigh_basic_400k.pt")
    pi.add_argument("--time_step", type=int, default=1)
    pi.add_argument("--ode_method", default="midpoint", choices=["euler", "midpoint"])
    pi.add_argument("--cfm_method", default="basic_cfm",
                    choices=["basic_cfm", "independent_cfm_adaptive",
                             "independent_cfm_constant", "independent_cfm_mix"])
    pi.add_argument("--sigma", type=float, default=0.0)
    pi.add_argument("--architecture", default="transformer",
                    choices=["transformer", "convnext"])
    pi.add_argument("--n_layers", type=int, default=2)
    pi.add_argument("--streaming", action="store_true",
                    help="chunked overlap-add for long clips")
    pi.add_argument("--longform", default=None,
                    choices=["streaming", "single_pass"],
                    help="long-clip strategy: chunked streaming (default "
                         "for >30 s) or single-pass full-context CFM "
                         "(seam-free)")
    pi.add_argument("--tiny", action="store_true",
                    help="tiny random model (smoke tests)")
    _device_flag(pi)
    pi.set_defaults(fn=cmd_infer)

    pt = sub.add_parser("train", help="train the CFM vector field")
    pt.add_argument("--config", default=None,
                    help="reference configs/config.json schema")
    pt.add_argument("--steps", type=int, default=None)
    pt.add_argument("--save_dir", default=None)
    pt.add_argument("--resume", default=None)
    pt.add_argument("--tp", type=int, default=1, help="tensor-parallel width")
    _device_flag(pt)
    pt.set_defaults(fn=cmd_train)

    pv = sub.add_parser("vocoder", help="standalone BigVGAN inference")
    pv.add_argument("--input_dir", required=True)
    pv.add_argument("--output_dir", required=True)
    pv.add_argument("--checkpoint", default=None)
    pv.add_argument("--config", default=None)
    _device_flag(pv)
    pv.set_defaults(fn=cmd_vocoder)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
