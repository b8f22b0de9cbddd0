"""The plain reference: FlowHigh's pipeline, training step and GAN step in
plain PyTorch and NumPy, independent of the program (it imports nothing of
``flowhigh_tpu_torch`` or of the JAX package)."""
