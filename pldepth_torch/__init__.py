"""pldepth_torch: the PyTorch / CUDA (Hopper) port of pldepth_tpu.

Imports torch and numpy only. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; CUDA kernels are built with nvcc at first use
(ops/_build.py).
"""

__version__ = "0.1.0"
