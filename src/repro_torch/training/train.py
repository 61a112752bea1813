"""Train-step factory, counterpart of ``repro/training/train.py``.

:func:`make_train_step` builds ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the loss and its gradient
(:func:`repro_torch.models.model.loss_fn`, remat per period inside the
model), then :func:`repro_torch.training.optim.adamw_update`.  With
``accum_steps > 1`` the batch splits on axis 0 into microbatches whose
gradients add up in float32, as the reference's.  On the card the
gradient runs the backward kernels of rows 9 and 10 (``onehot`` gather,
sLSTM recurrence) beside their forwards.
"""

from __future__ import annotations

import time

import torch

from ..models.model import loss_fn
from .optim import AdamWConfig, adamw_update

__all__ = ["make_train_step", "make_eval_step"]


def _grads(params, loss: torch.Tensor) -> dict:
    """``{name: d loss / d param}``; zeros for a parameter the loss does
    not reach (the reference's gradient of an unused leaf)."""
    named = dict(params.named_parameters())
    got = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(named.items(), got)}


def _micro(batch: dict, k: int, accum_steps: int) -> dict:
    """Microbatch ``k`` of ``accum_steps``: rows ``[k b, (k + 1) b)``."""
    out = {}
    for name, x in batch.items():
        x = torch.as_tensor(x)
        n = x.shape[0] // accum_steps
        out[name] = x[k * n:(k + 1) * n]
    return out


def _synced_clock(params) -> float:
    """The host clock once the parameters' device has finished its work."""
    dev = next(params.parameters()).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def make_train_step(cfg, opt_cfg: AdamWConfig, *, moe_impl: str = "scatter",
                    remat: bool = True, accum_steps: int = 1,
                    update_times: list | None = None):
    """Returns ``train_step(params, opt_state, batch)``.  ``params`` is a
    :class:`repro_torch.models.GenericLM` (made trainable here); it and
    ``opt_state`` are updated in place and returned.  ``metrics``:
    ``loss``, ``lm_loss``, ``aux_loss``, ``grad_norm``, ``lr`` (0-d
    tensors; with ``accum_steps > 1``, ``loss`` is the microbatches'
    mean and the others are the last microbatch's, as the reference's).
    With ``update_times`` (a list), each step appends its AdamW update's
    seconds, the device synchronised before and after it."""

    def loss_of(params, batch):
        return loss_fn(params, cfg, batch, moe_impl=moe_impl, remat=remat)

    def single(params, batch):
        loss, metrics = loss_of(params, batch)
        return loss.detach(), metrics, _grads(params, loss)

    def accumulated(params, batch):
        loss_sum, acc, metrics = None, None, None
        for k in range(accum_steps):
            loss, metrics = loss_of(params, _micro(batch, k, accum_steps))
            grads = _grads(params, loss)
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            if acc is None:
                acc = {n: g.to(torch.float32) for n, g in grads.items()}
            else:
                for n, g in grads.items():
                    acc[n] += g.to(torch.float32)
            del grads
        div = torch.full((), float(accum_steps), dtype=torch.float32,
                         device=loss_sum.device)
        return loss_sum / div, metrics, {n: g / div for n, g in acc.items()}

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        if accum_steps > 1:
            loss, metrics, grads = accumulated(params, batch)
        else:
            loss, metrics, grads = single(params, batch)
        if update_times is not None:
            t0 = _synced_clock(params)
        params, opt_state, stats = adamw_update(grads, params, opt_state,
                                                opt_cfg)
        if update_times is not None:
            update_times.append(_synced_clock(params) - t0)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(stats)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg, *, moe_impl: str = "scatter"):
    """Returns ``eval_step(params, batch) -> {"loss", "lm_loss",
    "aux_loss"}``, no gradient and no remat."""

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, cfg, batch, moe_impl=moe_impl,
                                remat=False)
        return {"loss": loss, **metrics}

    return eval_step
