"""Typed configuration for flowhigh_tpu_torch.

The same dataclasses, fields and defaults as the JAX package's
``flowhigh_tpu/config.py`` (kept as a copy: this package imports nothing of
the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Mel frontend (reference: src/flowhigh/models/melvoco.py:17-31)."""
    sampling_rate: int = 48000
    n_fft: int = 2048
    win_length: int = 2048
    hop_length: int = 480
    n_mels: int = 256
    f_min: float = 20.0
    f_max: float = 24000.0


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """BigVGAN generator hyperparams (vocoder config JSON schema of the
    published bigvgan_48khz_256band checkpoint; reference:
    src/flowhigh/models/bigvgan/models.py:124-170)."""
    num_mels: int = 256
    upsample_initial_channel: int = 1536
    upsample_rates: tuple[int, ...] = (5, 4, 4, 3, 2)
    upsample_kernel_sizes: tuple[int, ...] = (11, 8, 8, 7, 4)
    resblock: str = "1"
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"
    snake_logscale: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Vector-field network (reference: src/flowhigh/models/flow.py:55-75,
    configs/config.json:20-31)."""
    architecture: str = "transformer"  # transformer | convnext
    dim_in: int = 256
    dim: int = 1024
    depth: int = 2
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 4
    ff_dropout: float = 0.0
    attn_dropout: float = 0.0
    conv_pos_embed_kernel_size: int = 31
    attn_qk_norm: bool = True
    attn_qk_norm_scale: float = 10.0
    attn_flash: bool = False  # JAX package: blockwise attention (long-form); unused here
    rope_theta: float = 50000.0
    # optional reference transformer features (transformer.py:119-154);
    # off by default and unused by the published checkpoints
    num_register_tokens: int = 0
    use_unet_skip_connection: bool = False
    skip_connect_scale: Optional[float] = None  # default 2**-0.5 when used
    use_gateloop_layers: bool = False
    convnext_layers: int = 8
    convnext_mult: int = 3
    compute_dtype: str = "float32"  # this package computes in float32 only


@dataclasses.dataclass(frozen=True)
class CFMConfig:
    """Flow-matching path + solver (reference:
    src/flowhigh/cfm_superresolution.py:94-119)."""
    cfm_method: str = "basic_cfm"
    sigma: float = 0.0
    ode_method: str = "midpoint"  # euler | midpoint
    cond_drop_prob: float = 0.0

    CFM_METHODS = (
        "basic_cfm",
        "independent_cfm_adaptive",
        "independent_cfm_constant",
        "independent_cfm_mix",
    )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Degradation pipeline (reference: configs/config.json:3-19,
    src/flowhigh/train/data.py:92-131)."""
    data_path: str = ""
    valid_path: str = ""
    sampling_rate: int = 48000
    downsample_min: int = 4000
    downsample_max: int = 32000
    downsample_step: int = 1000
    downsampling_method: str = "scipy"
    segment_frames: int = 200  # 2 s at 100 frames/s (cfm_superresolution.py:472)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer hyperparams (reference: configs/config.json:33-44,
    src/flowhigh/train/trainer.py:73-94)."""
    batch_size: int = 128
    lr: float = 3e-4
    initial_lr: float = 1e-5
    num_train_steps: int = 400001
    num_warmup_steps: int = 0
    grad_accum_every: int = 1
    max_grad_norm: float = 0.5
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    adam_eps: float = 1e-8
    log_every: int = 10
    save_results_every: int = 100  # validation cadence (trainer.py:84,322)
    valid_frac: float = 0.05       # random_split fraction (trainer.py:82,122)
    save_model_every: int = 100000
    save_dir: str = "./results"
    weighted_loss: bool = False
    cond_freq_masking: bool = False
    random_seed: int = 104
    random_split_seed: int = 53
    # training-compute dtype of the JAX package's trainer (not ported)
    amp_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class FlowHighConfig:
    mel: MelConfig = MelConfig()
    vocoder: VocoderConfig = VocoderConfig()
    model: ModelConfig = ModelConfig()
    cfm: CFMConfig = CFMConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()

    def replace(self, **kw: Any) -> "FlowHighConfig":
        return dataclasses.replace(self, **kw)
