"""GenericLM, counterpart of ``repro/models/model.py``: ``embed -> blocks
-> norm -> unembed``, where the blocks repeat the config's block pattern.

The reference stacks the parameters of each pattern slot ``b{j}`` along a
leading ``n_periods`` axis and scans over it; the port keeps one module
per layer in :attr:`GenericLM.layers`, layer ``i`` being period ``i //
period``, slot ``i % period`` (:func:`repro_torch.convert.lm_params_from_reference`
maps one onto the other).  The decode cache keeps the reference's layout,
``{"blocks": {"b{j}": {leaf: (n_periods, B, ...)}}}``.

Entry points, as the reference's (no remat; the port does not train):

* :func:`init_model`   -> :class:`GenericLM`, drawn from a seed
* :func:`forward`      -> (logits, aux loss)
* :func:`prefill`      -> (last-token logits, filled cache)
* :func:`decode_step`  -> (logits, cache)
* :func:`init_cache`   -> decode cache

The port runs the ``mlstm``/``slstm`` block kinds (xlstm-125m); a config
that needs anything else raises :class:`NotImplementedError` naming the
ROADMAP item.  The reference's ``dist/sharding.shard_constraint`` is the
identity without a mesh and has no counterpart yet.
"""

from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from .blocks import (block_forward, block_prefill, block_step, init_block,
                     init_block_cache, unported)
from .layers import (DTYPES, Params, apply_norm, embed_lookup, init_embed,
                     init_norm, unembed)

__all__ = ["GenericLM", "check_supported", "init_model", "forward",
           "prefill", "decode_step", "init_cache"]


def check_supported(cfg) -> None:
    """Raise :class:`NotImplementedError` for what the port cannot run
    yet: block kinds other than ``mlstm``/``slstm``, MLPs, MoE,
    encoder-decoders, modality frontends and sinusoidal positions.  What
    is left has no attention, so positions play no part."""
    if cfg.enc_dec:
        raise unported("cross")
    if cfg.frontend:
        raise NotImplementedError(
            f"the {cfg.frontend} frontend is not ported yet; it comes with "
            f"attention and RoPE (ROADMAP Queue 1, item 4)")
    if cfg.rope == "none":
        raise NotImplementedError(
            "sinusoidal positions (rope='none') are not ported yet; they "
            "come with attention and RoPE (ROADMAP Queue 1, item 4)")
    for kind in cfg.block_pattern:
        if kind not in ("mlstm", "slstm"):
            raise unported(kind)
    if cfg.moe:
        raise unported("moe")
    if cfg.d_ff:
        raise unported("mlp")


def compute_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


class GenericLM(Params):
    """The model's parameters: ``embed``, ``norm_f_*`` and one
    :class:`Params` block per layer in :attr:`layers`."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: torch.Generator | None):
        check_supported(cfg)
        super().__init__(compute_dtype(cfg), device, generator)
        self.cfg = cfg
        init_embed(self, cfg.vocab, cfg.d_model, cfg.tie_embeddings)
        init_norm(self, "norm_f", cfg.d_model, cfg.norm)
        self.layers = nn.ModuleList()
        for i in range(cfg.n_layers):
            block = Params(compute_dtype(cfg), device, generator)
            init_block(block, cfg, cfg.block_pattern[i % cfg.period])
            self.layers.append(block)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_model(cfg, *, seed: int = 0,
               generator: torch.Generator | None = None,
               device="cuda") -> GenericLM:
    """A :class:`GenericLM` on ``device`` (the card by default), drawn
    from ``generator`` or, without one, from a generator seeded with
    ``seed``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return GenericLM(cfg, device=dev, generator=generator)


def _tokens(params: GenericLM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, dtype=torch.int64, device=params.device)


def _layers(cfg):
    """``(i, period index, slot, kind)`` of every layer."""
    for i in range(cfg.n_layers):
        p, j = divmod(i, cfg.period)
        yield i, p, j, cfg.block_pattern[j]


def _stack(per_slot: dict) -> dict:
    """Per-slot lists of per-period caches -> the reference's layout."""
    return {"blocks": {
        f"b{j}": {k: torch.stack([c[k] for c in caches])
                  for k in caches[0]}
        for j, caches in per_slot.items()}}


def forward(params: GenericLM, cfg, batch: dict):
    """Logits ``(B, S, vocab)`` float32 and the auxiliary loss (0: no
    MoE) for ``batch["tokens"]`` ``(B, S)``."""
    dtype = compute_dtype(cfg)
    x = embed_lookup(params, _tokens(params, batch["tokens"]),
                     impl=cfg.gather_impl, compute_dtype=dtype)
    for i, _, _, kind in _layers(cfg):
        x = block_forward(params.layers[i], cfg, kind, x, dtype=dtype)
    x = apply_norm(params, "norm_f", x, cfg.norm)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params, x, cfg.tie_embeddings, dtype), aux


def init_cache(cfg, batch: int, max_len: int, *, device="cuda") -> dict:
    """The decode cache of ``batch`` sequences (``max_len`` sizes the
    attention kinds' caches; the recurrent states have no time axis)."""
    dev = resolve_device(device)
    check_supported(cfg)
    one = {f"b{j}": init_block_cache(cfg, kind, batch, device=dev)
           for j, kind in enumerate(cfg.block_pattern)}
    return {"blocks": {
        name: {k: v.unsqueeze(0).repeat((cfg.n_periods,) + (1,) * v.ndim)
               for k, v in leaves.items()}
        for name, leaves in one.items()}}


def prefill(params: GenericLM, cfg, batch: dict, max_len: int):
    """Run the prompt; return (last-position logits ``(B, 1, vocab)``,
    filled cache).  ``max_len`` is the cache's, as in :func:`init_cache`."""
    dtype = compute_dtype(cfg)
    x = embed_lookup(params, _tokens(params, batch["tokens"]),
                     impl=cfg.gather_impl, compute_dtype=dtype)
    caches = {j: [] for j in range(cfg.period)}
    for i, _, j, kind in _layers(cfg):
        x, cache = block_prefill(params.layers[i], cfg, kind, x,
                                 dtype=dtype)
        caches[j].append(cache)
    x = apply_norm(params, "norm_f", x, cfg.norm)
    logits = unembed(params, x[:, -1:], cfg.tie_embeddings, dtype)
    return logits, _stack(caches)


def decode_step(params: GenericLM, cfg, cache: dict, tokens, index):
    """One token for the whole batch.  ``tokens``: (B, 1); ``index``, the
    position, is the attention kinds' (the recurrent blocks carry it in
    their state)."""
    dtype = compute_dtype(cfg)
    x = embed_lookup(params, _tokens(params, tokens),
                     impl=cfg.gather_impl, compute_dtype=dtype)
    caches = {j: [] for j in range(cfg.period)}
    for i, p, j, kind in _layers(cfg):
        cc = {k: v[p] for k, v in cache["blocks"][f"b{j}"].items()}
        x, nc = block_step(params.layers[i], cfg, kind, x, cc, dtype=dtype)
        caches[j].append(nc)
    x = apply_norm(params, "norm_f", x, cfg.norm)
    return unembed(params, x, cfg.tie_embeddings, dtype), _stack(caches)
