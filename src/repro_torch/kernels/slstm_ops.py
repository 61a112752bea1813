"""Wrapper of the sLSTM recurrence (kernel row 10), counterpart of
``repro/kernels/slstm_ops.py::fused_slstm_forward``.

:func:`slstm_recurrence` launches the CUDA kernel (``csrc/slstm.cu``,
through :func:`.slstm.launch_slstm`) for gates on a CUDA device and
raises if it cannot; for gates on the CPU it runs the plain version
:func:`.slstm_ref.slstm_recurrence_ref`.  :func:`fused_slstm_forward` is
the whole sLSTM mixer around it: the ``zifo`` projection, the
recurrence, the out-projection.  Beyond the reference it takes an
initial state and can return the final one, which is how the model's
prefill fills the decode cache and its decode step advances it
(:mod:`repro_torch.models.ssm`).
"""

from __future__ import annotations

import torch

from ..models.layers import dense
from .slstm import launch_slstm
from .slstm_ref import init_slstm_state, slstm_recurrence_ref

__all__ = ["fused_slstm_forward", "slstm_recurrence"]


def slstm_recurrence(zifo: torch.Tensor, r: torch.Tensor,
                     state: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``zifo``: ``(B, S, 4, di)``; ``r``: ``(4, di)``; ``state``: ``(4, B,
    di)`` ``(c, n, h, m)``, or ``None`` for a fresh sequence.  Computes in
    float32; returns the hidden states ``(B, S, di)`` and the final
    state."""
    B, _, _, di = zifo.shape
    zifo, r = zifo.float(), r.float()
    if state is None:
        state = init_slstm_state(B, di, device=zifo.device)
    state = state.float()
    if zifo.is_cuda:
        return launch_slstm(zifo.contiguous(), r.contiguous(),
                            state.contiguous())
    if zifo.device.type != "cpu":
        raise ValueError(f"gates lie on {zifo.device}: the recurrence runs "
                         f"on a CUDA device or, as its plain version, the "
                         f"CPU")
    return slstm_recurrence_ref(zifo, r, state)


def fused_slstm_forward(params, cfg, x: torch.Tensor, *,
                        dtype=torch.bfloat16,
                        state: torch.Tensor | None = None,
                        return_state: bool = False):
    """The sLSTM mixer on ``x`` ``(B, S, d)``: numerically the reference's
    ``slstm_forward``.  The gate projection and the out-projection are
    PyTorch matrix products; only the recurrence runs in the kernel (one
    read of the gates, one write of the hidden states).  With
    ``return_state`` also returns the final ``(4, B, di)`` state."""
    B, S, _ = x.shape
    di = cfg.d_inner
    zifo = dense(params, "zifo", x, dtype).float().reshape(B, S, 4, di)
    hs, final = slstm_recurrence(zifo, params["r_zifo"], state)
    out = dense(params, "out_proj", hs.to(dtype), dtype)
    if return_state:
        return out, final
    return out
