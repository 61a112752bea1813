"""The one device rule every entry point of the port follows.

Entry points take ``device=`` and default to ``"cuda"``.  With no card
present the default raises: the CPU runs only when a caller asks for
it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_f32", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a :class:`torch.device`, refusing CUDA when
    no card is visible instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but "
                f"torch.cuda.is_available() is False; pass device='cpu' to "
                f"run the plain path on the host")
        if dev.index is None:       # compare equal to tensor.device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` (tensor, numpy array or nested sequence) as float32 on
    ``device``; a tensor already there is returned as it is."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)
