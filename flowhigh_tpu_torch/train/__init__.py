"""Training, counterpart of ``flowhigh_tpu/train``: the vector field's
CFM trainer (``Trainer``, ``TrainState``), its optimizer and schedule
(``make_optimizer``, ``lr_schedule``), the vocoder's GAN trainer
(``VocoderTrainer``, ``VocoderTrainState``) and the data pipeline
(``train.data``: the degrading datasets, ``batch_iterator``, the seeded
split, the wav reader)."""

from .data import (AudioDataset, Subset, SyntheticAudioDataset,
                   VocoderSegmentDataset, batch_iterator, load_wav_mono,
                   random_split, scan_checkpoints)
from .optimizer import Optimizer, lr_schedule, make_optimizer
from .trainer import Trainer, TrainState
from .vocoder_trainer import VocoderTrainer, VocoderTrainState

__all__ = ["load_wav_mono", "make_optimizer", "lr_schedule", "Optimizer",
           "AudioDataset", "SyntheticAudioDataset", "VocoderSegmentDataset",
           "batch_iterator", "random_split", "scan_checkpoints", "Subset",
           "Trainer", "TrainState", "VocoderTrainer", "VocoderTrainState"]
