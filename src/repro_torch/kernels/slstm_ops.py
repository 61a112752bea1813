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

When the gates or ``r`` require a gradient, :func:`slstm_recurrence`
runs as a :class:`torch.autograd.Function`: on the card its forward is
the training instance of the kernel (:func:`.slstm.launch_slstm_train`,
which keeps each step's state) and its backward the backward kernel
(row 10b, :func:`.slstm.launch_slstm_backward`); on the CPU both are the
plain versions.  Training starts every sequence from a fresh state: an
initial state that requires a gradient is refused, and the final state
carries none.
"""

from __future__ import annotations

import torch

from ..models.layers import dense
from .slstm import launch_slstm, launch_slstm_backward, launch_slstm_train
from .slstm_ref import (init_slstm_state, slstm_backward_ref,
                        slstm_recurrence_ref)

__all__ = ["fused_slstm_forward", "slstm_recurrence"]


def slstm_recurrence(zifo: torch.Tensor, r: torch.Tensor,
                     state: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``zifo``: ``(B, S, 4, di)``; ``r``: ``(4, di)``; ``state``: ``(4, B,
    di)`` ``(c, n, h, m)``, or ``None`` for a fresh sequence.  Computes in
    float32; returns the hidden states ``(B, S, di)`` and the final
    state."""
    B, _, _, di = zifo.shape
    if state is not None and state.requires_grad:
        raise ValueError("the sLSTM recurrence takes no gradient into its "
                         "initial state: training starts from a fresh "
                         "state")
    zifo, r = zifo.float(), r.float()
    if state is None:
        state = init_slstm_state(B, di, device=zifo.device)
    state = state.float()
    if zifo.device.type not in ("cuda", "cpu"):
        raise ValueError(f"gates lie on {zifo.device}: the recurrence runs "
                         f"on a CUDA device or, as its plain version, the "
                         f"CPU")
    if torch.is_grad_enabled() and (zifo.requires_grad or r.requires_grad):
        return _Recurrence.apply(zifo, r, state)
    if zifo.is_cuda:
        return launch_slstm(zifo.contiguous(), r.contiguous(),
                            state.contiguous())
    return slstm_recurrence_ref(zifo, r, state)


class _Recurrence(torch.autograd.Function):
    """The recurrence with its backward: kernels on the card (rows 10
    and 10b), the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, zifo, r, state):
        if zifo.is_cuda:
            zifo, r, state = (t.contiguous() for t in (zifo, r, state))
            hs, final, states = launch_slstm_train(zifo, r, state)
            ctx.save_for_backward(zifo, r, state, hs, states)
        else:
            hs, final = slstm_recurrence_ref(zifo, r, state)
            ctx.save_for_backward(zifo, r, state)
        ctx.mark_non_differentiable(final)
        return hs, final

    @staticmethod
    def backward(ctx, dhs, _dfinal):
        saved = ctx.saved_tensors
        if saved[0].is_cuda:
            zifo, r, state, hs, states = saved
            dzifo, dr = launch_slstm_backward(zifo, r, state, hs, states,
                                              dhs.float().contiguous())
        else:
            dzifo, dr = slstm_backward_ref(*saved, dhs)
        return dzifo, dr, None


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
