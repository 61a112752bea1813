"""Hand-written CUDA kernels of the port, each with its triple: the
kernel (``csrc/``), a wrapper that checks, pads and launches it, and a
plain PyTorch version (``*_ref``) that the CPU path runs.

Nothing is built or loaded at import time; the first launch builds.
"""

from .backproject import LAUNCHES
from .backproject_ops import backproject_batch, backproject_one

__all__ = ["LAUNCHES", "backproject_batch", "backproject_one"]
