"""Seeded weights on the device, in the reference checkpoints' layouts.

Each network's weights come from one ``torch.randn`` on the device from a
generator seeded by the run's seed, and are then cut into the reference's
tensors and scaled: a Linear or conv weight by 1 / sqrt(its fan-in) (the
generator's last conv by 0.03 of that), a bias
to 0.02, a norm's gain to 1 + 0.05 n, the adaptive norm's gain bias to
1 + 0.02 n, a snake's log-alpha and log-beta to 0.1 n, the sinusoidal time
frequencies to n. Weight-normed convs get v so and g = |v| (1 + 0.05 n).
The same tensors go to the program, through its reference-layout loaders,
and to the plain reference."""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    state = np.random.SeedSequence([int(seed), *tags]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def field_shapes(model: dict) -> dict:
    """{reference key: shape} of the vector field (the checkpoint's keys
    without the ``flowhigh.`` prefix)."""
    d, din, h, dh = model["dim"], model["dim_in"], model["heads"], model["dim_head"]
    inner = int(d * model["ff_mult"] * 2 / 3)
    k = model["conv_pos_embed_kernel_size"]
    out = {"null_cond": (din,), "sinu_pos_emb.0.weights": (d // 2,),
           "sinu_pos_emb.1.weight": (d, d), "sinu_pos_emb.1.bias": (d,),
           "to_embed.weight": (d, 2 * din), "to_embed.bias": (d,),
           "conv_embed.dw_conv1d.0.weight": (d, 1, k),
           "conv_embed.dw_conv1d.0.bias": (d,)}
    for i in range(model["depth"]):
        p = f"transformer.layers.{i}."
        for slot in (2, 4):
            for which in ("to_gamma", "to_beta"):
                out[f"{p}{slot}.{which}.weight"] = (d, d)
                out[f"{p}{slot}.{which}.bias"] = (d,)
        out[p + "3.q_norm.gamma"] = (h, 1, dh)
        out[p + "3.k_norm.gamma"] = (h, 1, dh)
        out[p + "3.to_qkv.weight"] = (3 * h * dh, d)
        out[p + "3.to_out.weight"] = (d, h * dh)
        out[p + "5.0.weight"] = (2 * inner, d)
        out[p + "5.0.bias"] = (2 * inner,)
        out[p + "5.3.weight"] = (d, inner)
        out[p + "5.3.bias"] = (d,)
    out["transformer.final_norm.gamma"] = (d,)
    out["to_pred.weight"] = (din, d)
    return out


def vocoder_shapes(voc: dict) -> dict:
    """{reference key: shape} of the weight-normed generator: ``weight_v``
    entries (``weight_g`` follows from them), biases, snake parameters."""
    ch = voc["upsample_initial_channel"]
    out = {"conv_pre.weight_v": (ch, voc["num_mels"], 7), "conv_pre.bias": (ch,)}
    nk = len(voc["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(voc["upsample_rates"],
                                   voc["upsample_kernel_sizes"])):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        out[f"ups.{i}.0.weight_v"] = (cin, cout, k)
        out[f"ups.{i}.0.bias"] = (cout,)
        for j, (rk, rd) in enumerate(zip(voc["resblock_kernel_sizes"],
                                         voc["resblock_dilation_sizes"])):
            b = f"resblocks.{i * nk + j}."
            for m in range(len(rd)):
                for which in ("convs1", "convs2"):
                    out[f"{b}{which}.{m}.weight_v"] = (cout, cout, rk)
                    out[f"{b}{which}.{m}.bias"] = (cout,)
            for a in range(2 * len(rd)):
                out[f"{b}activations.{a}.act.alpha"] = (cout,)
                out[f"{b}activations.{a}.act.beta"] = (cout,)
    out["activation_post.act.alpha"] = (cout,)
    out["activation_post.act.beta"] = (cout,)
    out["conv_post.weight_v"] = (1, cout, 7)
    out["conv_post.bias"] = (1,)
    return out


def discriminator_shapes(periods, resolutions) -> dict:
    """{key: shape} of the MPD (``mpd.discriminators.i``) and the MRD
    (``mrd.discriminators.i``), weight-normed: ``weight_v`` and bias
    entries."""
    out = {}

    def conv(base, cin, cout, kh, kw):
        out[base + ".weight_v"] = (cout, cin, kh, kw)
        out[base + ".bias"] = (cout,)
    for i, _ in enumerate(periods):
        b, cin = f"mpd.discriminators.{i}", 1
        for j, cout in enumerate((32, 128, 512, 1024, 1024)):
            conv(f"{b}.convs.{j}", cin, cout, 5, 1)
            cin = cout
        conv(f"{b}.conv_post", cin, 1, 3, 1)
    for i, _ in enumerate(resolutions):
        b = f"mrd.discriminators.{i}"
        for j, k in enumerate(((3, 9),) * 4 + ((3, 3),)):
            conv(f"{b}.convs.{j}", 1 if j == 0 else 32, 32, *k)
        conv(f"{b}.conv_post", 32, 1, 3, 3)
    return out


def draw(shapes: dict, seed: int, device, scale=None) -> dict:
    """Tensors for ``shapes`` from one normal draw on ``device``;
    ``scale`` = {key: factor} on the default scale of those keys."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, start = {}, 0
    for (key, shape), size in zip(shapes.items(), sizes):
        n = flat[start:start + size].view(shape)
        start += size
        if key.endswith(("weight", "weight_v")) and len(shape) >= 2:
            t = n / float(np.prod(shape[1:])) ** 0.5
        elif key.endswith("to_gamma.bias"):
            t = 1.0 + 0.02 * n
        elif key.endswith("bias"):
            t = 0.02 * n
        elif key.endswith("gamma"):
            t = 1.0 + 0.05 * n
        elif key.endswith((".alpha", ".beta")):
            t = 0.1 * n
        elif key == "null_cond":
            t = torch.zeros_like(n)
        else:  # the time embedding's frequencies
            t = n.clone()
        out[key] = (t * (scale or {}).get(key, 1.0)).contiguous()
    return out


def weight_norm_gains(sd: dict, seed: int) -> dict:
    """Adds ``weight_g`` = |v| (1 + 0.05 n) beside every ``weight_v``."""
    keys = [k for k in sd if k.endswith("weight_v")]
    dev = sd[keys[0]].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(sum(sd[k].shape[0] for k in keys), generator=gen,
                        device=dev)
    out, start = dict(sd), 0
    for key in keys:
        v = sd[key]
        dims = tuple(range(1, v.ndim))
        norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
        n = noise[start:start + v.shape[0]].view(norm.shape)
        start += v.shape[0]
        out[key[:-1] + "g"] = norm * (1.0 + 0.05 * n)
    return out


def field_weights(cfg: dict, seed: int, device) -> dict:
    return draw(field_shapes(cfg["model"]), sub_seed(seed, 1), device)


def vocoder_weights(cfg: dict, seed: int, device) -> dict:
    # conv_post at 0.03 of the fan-in scale: the generator's output is then
    # about 0.3 RMS, audio as a trained generator makes it, where the plain
    # fan-in scale saturates tanh on most samples
    sd = draw(vocoder_shapes(cfg["vocoder"]), sub_seed(seed, 2), device,
              scale={"conv_post.weight_v": 0.03})
    return weight_norm_gains(sd, sub_seed(seed, 3))


def discriminator_weights(cfg: dict, seed: int, device) -> dict:
    g = cfg["gan"]
    sd = draw(discriminator_shapes(g["periods"], g["resolutions"]),
              sub_seed(seed, 40), device)
    return weight_norm_gains(sd, sub_seed(seed, 41))
