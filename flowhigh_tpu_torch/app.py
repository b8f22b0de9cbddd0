"""Gradio web demo of the port — counterpart of the repository's root
``app.py``. Imports without gradio; ``python -m flowhigh_tpu_torch.app``
serves the demo where gradio is installed and exits with a hint otherwise.
The model is fetched on the first request (``FlowHighSR.from_pretrained``,
which needs network access) and runs on the card."""

from __future__ import annotations

import numpy as np

from .sr import FlowHighSR

try:
    import gradio as gr
except ImportError:
    gr = None

model = None


def generate(audio, target_sr: int = 48000, timestep: int = 1):
    """The gradio callback: (rate, int16 or float waveform) -> (48000,
    int16 waveform)."""
    global model
    if model is None:
        model = FlowHighSR.from_pretrained(device=None)
    sr, wav = audio
    wav = np.asarray(wav, dtype=np.float32)
    out = model.generate(wav, sr, target_sr, timestep)
    return 48000, (np.clip(out[0], -1, 1) * 32767).astype(np.int16)


def main() -> None:
    if gr is None:
        raise SystemExit(
            "gradio is not installed; use `python -m flowhigh_tpu_torch.cli "
            "infer` for file-to-file inference instead")
    demo = gr.Interface(
        fn=generate,
        inputs=[
            gr.Audio(label="Low-resolution audio"),
            gr.Radio([16000, 24000, 32000, 44100, 48000], value=48000,
                     label="Target sampling rate"),
            gr.Slider(1, 50, value=1, step=1, label="ODE timesteps"),
        ],
        outputs=gr.Audio(label="48 kHz output"),
        title="FLowHigh on PyTorch/CUDA: audio super-resolution",
    )
    demo.launch()


if __name__ == "__main__":
    main()
