"""Training, counterpart of ``flowhigh_tpu/train``. Only the wav reader is
ported so far (``data.load_wav_mono``, which the CLI uses); the data
pipeline, the trainers and the discriminators are ROADMAP.md queue 1
item 12."""

from .data import load_wav_mono

__all__ = ["load_wav_mono"]
