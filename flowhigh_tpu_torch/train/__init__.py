"""Training, counterpart of ``flowhigh_tpu/train``: the vector field's
CFM trainer (``Trainer``, ``TrainState``), its optimizer and schedule
(``make_optimizer``, ``lr_schedule``) and the wav reader
(``data.load_wav_mono``). The degrading datasets and batch iterators are
ROADMAP.md queue 1 item 12(b); the vocoder's GAN trainer item 12(c)."""

from .data import load_wav_mono
from .optimizer import Optimizer, lr_schedule, make_optimizer
from .trainer import Trainer, TrainState

__all__ = ["load_wav_mono", "make_optimizer", "lr_schedule", "Optimizer",
           "Trainer", "TrainState"]
