"""flowhigh_tpu_torch — the PyTorch/CUDA port of flowhigh_tpu.

Any-rate -> 48 kHz audio super-resolution (conditional flow matching over
256-band mels, vocoded by BigVGAN) for an NVIDIA H100: plain PyTorch for
the DSP and the vector field, hand-written CUDA kernels (``csrc/``) for the
vocoder's anti-aliased snake, dilated conv, transposed conv and their fused
forms, and for the long-form mode's blockwise attention. The JAX package
``flowhigh_tpu`` stays the reference; this package imports none of it.
Entry points run on CUDA unless the caller passes ``device="cpu"``, where
every kernel wrapper takes its plain PyTorch version.
"""

from .config import (CFMConfig, DataConfig, FlowHighConfig, MelConfig,
                     ModelConfig, TrainConfig, VocoderConfig)
from .cfm_wrapper import ConditionalFlowMatcherWrapper, FLowHigh, init_bigvgan
from .metrics import boundary_lsd, log_spectral_distance
from .serving import ServingPipeline
from .sr import FlowHighSR
from .streaming import StreamingSR

__version__ = "0.3.0"  # the distribution's (pyproject.toml)

__all__ = [
    "FlowHighSR", "StreamingSR", "ServingPipeline", "FlowHighConfig",
    "MelConfig", "VocoderConfig", "ModelConfig", "CFMConfig", "DataConfig",
    "TrainConfig", "log_spectral_distance", "boundary_lsd", "FLowHigh",
    "ConditionalFlowMatcherWrapper", "init_bigvgan",
]
