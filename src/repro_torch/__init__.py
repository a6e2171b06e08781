"""PyTorch + CUDA port of the FL-over-NOMA system (``src/repro`` is the
JAX reference it is held against). Entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``."""
