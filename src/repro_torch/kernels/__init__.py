"""Hand-written CUDA kernels of the port, each with its triple: the
kernel (``csrc/``), a wrapper that checks, pads and launches it, and a
plain PyTorch version (``*_ref``) that the CPU path runs.

The kernels: ``csrc/backproject.cu`` (back projection, one instance
per projection wire: float32, bfloat16, int8), ``csrc/backproject_strip.cu``
(the strip-staged back projections K3 ``strip_db``, K4 ``strip_micro``
and K5 ``strip_shared``, on the same three wires), ``csrc/quant.cu``
(the int8 row encoder), and for the language model ``csrc/gather.cu``
(the embedding's one-hot row gather and its backward) and
``csrc/slstm.cu`` (the sLSTM recurrence, its training instance and its
backward).  Nothing is built or loaded at import time; the first launch
builds.
"""

from .backproject import LAUNCHES
from .backproject_ops import backproject_batch, backproject_one

__all__ = ["LAUNCHES", "backproject_batch", "backproject_one"]
