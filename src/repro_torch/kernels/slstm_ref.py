"""Plain PyTorch version of the sLSTM recurrence (kernel row 10).

The reference's ``repro/models/ssm.py::_slstm_cell`` iterated over the
sequence in float32, from an initial state ``(4, B, di)`` = ``(c, n, h,
m)`` (``m = -inf`` for a fresh sequence, :func:`init_slstm_state`) to the
final one.  The CUDA kernel ``csrc/slstm.cu`` computes the same function
on the card.  ``softplus`` is JAX's, ``logaddexp(x, 0)``:
``torch.nn.functional.softplus`` turns into the identity above 20.

:func:`slstm_backward_ref`, PyTorch's autograd through
:func:`slstm_recurrence_ref`, is the plain version of the backward
kernel (row 10b): the derivative of the reference's cell as
``jax.grad`` takes it, the gradient split evenly at a tie of each
``maximum``.
"""

from __future__ import annotations

import torch

__all__ = ["init_slstm_state", "slstm_backward_ref", "slstm_cell_ref",
           "slstm_recurrence_ref", "softplus"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_slstm_state(batch: int, di: int, *, device) -> torch.Tensor:
    """The state before the first token: ``c = n = h = 0``, ``m = -inf``."""
    state = torch.zeros((4, batch, di), dtype=torch.float32, device=device)
    state[3] = -torch.inf
    return state


def slstm_cell_ref(gates: torch.Tensor, r: torch.Tensor,
                   state: torch.Tensor) -> torch.Tensor:
    """One step.  ``gates``: ``(B, 4, di)`` pre-activations ``(z, i, f,
    o)``; ``r``: ``(4, di)``; ``state``: ``(4, B, di)``.  Returns the new
    state."""
    c, nvec, h, m = state.unbind(0)
    z_in, i_in, f_in, o_in = gates.unbind(1)
    z = torch.tanh(z_in + r[0] * h)
    ig = i_in + r[1] * h
    fg = f_in + r[2] * h
    o = torch.sigmoid(o_in + r[3] * h)
    logf = -softplus(-fg)
    m_new = torch.maximum(logf + m, ig)
    c_new = c * torch.exp(logf + m - m_new) + torch.exp(ig - m_new) * z
    n_new = nvec * torch.exp(logf + m - m_new) + torch.exp(ig - m_new)
    h_new = o * c_new / torch.maximum(n_new, torch.full_like(n_new,
                                                            1e-6))
    return torch.stack([c_new, n_new, h_new, m_new])


def slstm_recurrence_ref(zifo: torch.Tensor, r: torch.Tensor,
                         state: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``zifo``: ``(B, S, 4, di)``; ``r``: ``(4, di)``; ``state``: ``(4, B,
    di)``; all float32.  Returns the hidden states ``(B, S, di)`` and the
    final state."""
    hs = []
    for t in range(zifo.shape[1]):
        state = slstm_cell_ref(zifo[:, t], r, state)
        hs.append(state[2])
    if not hs:
        return zifo.new_zeros(zifo.shape[:2] + zifo.shape[3:]), state
    return torch.stack(hs, dim=1), state


def slstm_backward_ref(zifo: torch.Tensor, r: torch.Tensor,
                       state: torch.Tensor, dhs: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient ``dhs`` (B, S, di) of the hidden states of
    :func:`slstm_recurrence_ref` from ``state`` taken back to ``zifo``
    and ``r``: ``(d zifo, d r)``, float32, by autograd through the plain
    recurrence."""
    with torch.enable_grad():
        z = zifo.detach().float().requires_grad_(True)
        w = r.detach().float().requires_grad_(True)
        hs, _ = slstm_recurrence_ref(z, w, state.detach().float())
        return torch.autograd.grad(hs, (z, w), dhs.float())
