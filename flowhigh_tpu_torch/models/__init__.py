from .bigvgan import AMPBlock1, AMPBlock2, Activation1d, BigVGAN
from .melvoco import MelVoco
from .melvoco import encode as mel_encode
from .melvoco import encode_torchaudio
from .transformer import ConvPositionEmbed, LearnedSinusoidalPosEmb, Transformer
from .vector_field import VectorFieldNet, forward_with_cond_scale

__all__ = [
    "Transformer", "ConvPositionEmbed", "LearnedSinusoidalPosEmb",
    "VectorFieldNet", "forward_with_cond_scale",
    "BigVGAN", "Activation1d", "AMPBlock1", "AMPBlock2", "mel_encode",
    "encode_torchaudio", "MelVoco",
]
