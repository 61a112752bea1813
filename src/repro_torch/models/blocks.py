"""Residual blocks, counterpart of ``repro/models/blocks.py``: a
pre-normed mixer with a residual.

The port runs the ``mlstm`` and ``slstm`` kinds with no MLP (``d_ff =
0``: the reference's ``_ffn_part`` is then the identity with a zero
auxiliary loss), which is what xlstm-125m needs.  Any other kind or
feature raises :class:`NotImplementedError` naming the ROADMAP item that
ports it.  Three entry points, as the reference's:

* :func:`block_forward` — full sequence
* :func:`block_prefill` — full sequence, also returns the decode cache
* :func:`block_step`    — one token with cache
"""

from __future__ import annotations

import torch

from .layers import Params, apply_norm, init_norm
from .ssm import (init_mlstm, init_mlstm_cache, init_slstm,
                  init_slstm_cache, mlstm_forward, mlstm_step,
                  slstm_forward, slstm_step)

__all__ = ["init_block", "init_block_cache", "block_forward",
           "block_prefill", "block_step", "unported"]

# What each unported block kind or feature waits for.
_UNPORTED = {
    "attn": "attention and RoPE (ROADMAP Queue 1, item 4)",
    "cross": "cross-attention (ROADMAP Queue 1, item 4)",
    "mamba": "the Mamba mixer (ROADMAP Queue 1, item 5)",
    "mlp": "the MLP (ROADMAP Queue 1, item 6)",
    "moe": "MoE (ROADMAP Queue 1, item 6)",
}


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes with "
                               f"{_UNPORTED[what]}")


def _check(cfg, kind: str):
    if kind not in ("mlstm", "slstm"):
        if kind in _UNPORTED:
            raise unported(kind)
        raise ValueError(f"unknown mixer kind {kind!r}")
    if cfg.d_ff:
        raise unported("mlp")


def init_block(p: Params, cfg, kind: str):
    _check(cfg, kind)
    init_norm(p, "ln1", cfg.d_model, cfg.norm)
    mixer = p.sub("mixer")
    if kind == "mlstm":
        init_mlstm(mixer, cfg)
    else:
        init_slstm(mixer, cfg)


def init_block_cache(cfg, kind: str, batch: int, *, device) -> dict:
    """The decode cache of one block: recurrent state, no time axis."""
    _check(cfg, kind)
    if kind == "mlstm":
        return init_mlstm_cache(cfg, batch, device=device)
    return init_slstm_cache(cfg, batch, device=device)


def block_forward(params, cfg, kind: str, x: torch.Tensor, *,
                  dtype=torch.bfloat16) -> torch.Tensor:
    _check(cfg, kind)
    h = apply_norm(params, "ln1", x, cfg.norm)
    mixer = mlstm_forward if kind == "mlstm" else slstm_forward
    return x + mixer(params["mixer"], cfg, h, dtype=dtype)


def block_prefill(params, cfg, kind: str, x: torch.Tensor, *,
                  dtype=torch.bfloat16):
    """Forward + decode-cache extraction (the sequence fills ``[0, S)``)."""
    _check(cfg, kind)
    h = apply_norm(params, "ln1", x, cfg.norm)
    mixer = mlstm_forward if kind == "mlstm" else slstm_forward
    mix, cache = mixer(params["mixer"], cfg, h, dtype=dtype,
                       return_state=True)
    return x + mix, cache


def block_step(params, cfg, kind: str, x: torch.Tensor, cache: dict, *,
               dtype=torch.bfloat16):
    """One-token decode step.  ``x``: (B, 1, d)."""
    _check(cfg, kind)
    h = apply_norm(params, "ln1", x, cfg.norm)
    step = mlstm_step if kind == "mlstm" else slstm_step
    mix, new_cache = step(params["mixer"], cfg, h, cache, dtype=dtype)
    return x + mix, new_cache
