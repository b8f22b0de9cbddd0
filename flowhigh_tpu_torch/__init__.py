"""flowhigh_tpu_torch — the PyTorch/CUDA port of flowhigh_tpu.

Any-rate -> 48 kHz audio super-resolution (conditional flow matching over
256-band mels, vocoded by BigVGAN) for an NVIDIA H100: plain PyTorch for
the DSP and the vector field, hand-written CUDA kernels (``csrc/``) for the
vocoder's anti-aliased snake, dilated conv and transposed conv. The JAX
package ``flowhigh_tpu`` stays the reference; this package imports none of
it. Entry points run on CUDA unless the caller passes ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.
"""

from .config import (CFMConfig, DataConfig, FlowHighConfig, MelConfig,
                     ModelConfig, TrainConfig, VocoderConfig)
from .sr import FlowHighSR

__all__ = [
    "FlowHighSR", "FlowHighConfig", "MelConfig", "VocoderConfig",
    "ModelConfig", "CFMConfig", "DataConfig", "TrainConfig",
]
