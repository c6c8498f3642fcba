"""The plain reference that decides ``correct``: float32 PyTorch with TF32
off (``precision.strict_f32``), importing nothing of the program and no
JAX."""
