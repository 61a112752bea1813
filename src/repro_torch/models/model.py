"""GenericLM, counterpart of ``repro/models/model.py``: ``embed -> blocks
-> norm -> unembed``, where the blocks repeat the config's block pattern.

The reference stacks the parameters of each pattern slot ``b{j}`` along a
leading ``n_periods`` axis and scans over it; the port keeps one module
per layer in :attr:`GenericLM.layers`, layer ``i`` being period ``i //
period``, slot ``i % period`` (:func:`repro_torch.convert.lm_params_from_reference`
maps one onto the other).  The decode cache keeps the reference's layout,
``{"blocks": {"b{j}": {leaf: (n_periods, B, ...)}}}``.

An encoder-decoder (whisper) adds an encoder stack of ``attn`` blocks
(:attr:`GenericLM.enc_layers`, the reference's ``enc_blocks/b0``) and
cross-attention in every decoder block; a vision model (Qwen2-VL)
prepends projected patch features with M-RoPE positions.  The modality
frontends are the reference's stubs: one linear adapter over
precomputed frames (``batch["frames"]``) or patches
(``batch["patches"]``) of :data:`FRONTEND_DIM` features.

Entry points, as the reference's (no remat; the port does not train):

* :func:`init_model`   -> :class:`GenericLM`, drawn from a seed
* :func:`forward`      -> (logits, aux loss)
* :func:`prefill`      -> (last-token logits, filled cache)
* :func:`decode_step`  -> (logits, cache)
* :func:`init_cache`   -> decode cache

MoE replaces the MLP in the pattern slots :func:`_moe_flags` names
(``moe_impl`` chooses its dispatch, as the reference's).  The
reference's ``dist/sharding.shard_constraint`` is the identity without
a mesh and has no counterpart yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from .blocks import (block_forward, block_prefill, block_step, init_block,
                     init_block_cache)
from .layers import (DTYPES, Params, apply_norm, dense, embed_lookup,
                     init_dense, init_embed, init_norm, make_positions_mrope,
                     unembed)

__all__ = ["FRONTEND_DIM", "GenericLM", "init_model", "forward", "prefill",
           "decode_step", "init_cache"]

# Stub modality frontends: precomputed features -> linear adapter.
FRONTEND_DIM = {"audio": 80, "vision": 1176}


def _moe_flags(cfg) -> tuple:
    """Whether MoE replaces the MLP, for each slot of the pattern."""
    if cfg.moe and cfg.period % cfg.moe_every \
            and cfg.moe_every % cfg.period:
        raise ValueError("MoE placement must be periodic within the "
                         "block pattern")
    return tuple(cfg.moe_at(j) for j in range(cfg.period))


def compute_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


class GenericLM(Params):
    """The model's parameters: ``embed``, ``norm_f_*``, the ``frontend``
    adapter, one :class:`Params` block per layer in :attr:`layers`, and
    for an encoder-decoder one per encoder layer in :attr:`enc_layers`
    and ``norm_enc_*``."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: torch.Generator | None):
        super().__init__(compute_dtype(cfg), device, generator)
        self.cfg = cfg
        init_embed(self, cfg.vocab, cfg.d_model, cfg.tie_embeddings)
        init_norm(self, "norm_f", cfg.d_model, cfg.norm)
        if cfg.frontend:
            init_dense(self, "frontend", FRONTEND_DIM[cfg.frontend],
                       cfg.d_model)
        flags = _moe_flags(cfg)
        self.layers = self._blocks(
            cfg, [(cfg.block_pattern[j], flags[j])
                  for _, _, j, _ in _layers(cfg)], cfg.enc_dec)
        if cfg.enc_dec:
            self.enc_layers = self._blocks(
                cfg, [("attn", False)] * cfg.n_enc_layers, False)
            init_norm(self, "norm_enc", cfg.d_model, cfg.norm)

    def _blocks(self, cfg, kinds, cross: bool) -> nn.ModuleList:
        layers = nn.ModuleList()
        for kind, use_moe in kinds:
            block = Params(*self._init)
            init_block(block, cfg, kind, use_moe, cross=cross)
            layers.append(block)
        return layers

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


def _on(params: GenericLM, x, dtype=torch.int64) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=params.device)


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


# ----------------------------------------------------------------------
# Input embedding (+ frontends)
# ----------------------------------------------------------------------

def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, S) -> (B, S, d) fixed sinusoidal embedding (whisper-style),
    float32."""
    half = d // 2
    iota = torch.arange(half, dtype=torch.float32, device=positions.device)
    ex = -math.log(10_000.0) * iota
    freqs = torch.exp(ex / torch.full_like(ex, max(half - 1, 1)))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_inputs(params: GenericLM, cfg, batch: dict, dtype):
    """(x, positions): the token embeddings, after the projected patches
    of a vision model (with their M-RoPE grid positions); positions
    ``(B, S)``, or ``(3, B, S)`` under M-RoPE; sinusoids added under
    ``rope="none"``."""
    tokens = _on(params, batch["tokens"])
    B = tokens.shape[0]
    x = embed_lookup(params, tokens, impl=cfg.gather_impl,
                     compute_dtype=dtype)
    if cfg.frontend == "vision" and "patches" in batch:
        patches = dense(params, "frontend",
                        _on(params, batch["patches"], torch.float32), dtype)
        x = torch.cat([patches, x], dim=1)
        n_img = patches.shape[1]
        g = max(1, int(math.sqrt(n_img)))
        positions = make_positions_mrope(B, x.shape[1], n_img,
                                         (g, max(1, n_img // g)),
                                         device=x.device)
    else:
        S = x.shape[1]
        pos = torch.arange(S, dtype=torch.int32,
                           device=x.device).expand(B, S)
        positions = pos.expand(3, B, S) if cfg.rope == "mrope" else pos
        if cfg.rope == "none":
            x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
    return x, positions


def _encode(params: GenericLM, cfg, batch: dict, dtype):
    """The encoder stack over ``batch["frames"]`` (B, S, FRONTEND_DIM):
    (encoder output, its positions)."""
    x = dense(params, "frontend", _on(params, batch["frames"],
                                      torch.float32), dtype)
    B, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
    for block in params.enc_layers:
        x, _ = block_forward(block, cfg, "attn", False, x, pos,
                             causal=False, dtype=dtype)
    return apply_norm(params, "norm_enc", x, cfg.norm), pos


def _context(params, cfg, batch, dtype):
    """The embedded inputs and, for an encoder-decoder, the keyword
    arguments its decoder blocks take."""
    x, positions = _embed_inputs(params, cfg, batch, dtype)
    kw = {"cross": cfg.enc_dec}
    if cfg.enc_dec:
        kw["enc_out"], kw["enc_positions"] = _encode(params, cfg, batch,
                                                     dtype)
    return x, positions, kw


# ----------------------------------------------------------------------
# Forward / serving
# ----------------------------------------------------------------------

def forward(params: GenericLM, cfg, batch: dict, *,
            moe_impl: str = "scatter"):
    """Logits ``(B, S, vocab)`` float32 and the auxiliary loss (the MoE
    layers' load-balance losses summed, as the reference: per period,
    then over periods; 0 without MoE) for ``batch["tokens"]`` ``(B, S)``
    (plus ``patches`` or ``frames`` for the frontends)."""
    dtype = compute_dtype(cfg)
    x, positions, kw = _context(params, cfg, batch, dtype)
    flags = _moe_flags(cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    auxs = [zero] * cfg.n_periods
    for i, p, j, kind in _layers(cfg):
        x, a = block_forward(params.layers[i], cfg, kind, flags[j], x,
                             positions, moe_impl=moe_impl, dtype=dtype, **kw)
        if a is not None:
            auxs[p] = auxs[p] + a
    x = apply_norm(params, "norm_f", x, cfg.norm)
    return (unembed(params, x, cfg.tie_embeddings, dtype),
            torch.stack(auxs).sum())


def init_cache(cfg, batch: int, max_len: int, enc_len: int = 0, *,
               device="cuda") -> dict:
    """The decode cache of ``batch`` sequences: ``max_len`` positions of
    each attention block's KV cache (the recurrent states have no time
    axis) and ``enc_len`` of the encoder's keys and values."""
    dev = resolve_device(device)
    dtype = compute_dtype(cfg)
    one = {f"b{j}": init_block_cache(cfg, kind, batch, max_len,
                                     cross=cfg.enc_dec, enc_len=enc_len,
                                     dtype=dtype, device=dev)
           for j, kind in enumerate(cfg.block_pattern)}
    return {"blocks": {
        name: {k: v.unsqueeze(0).repeat((cfg.n_periods,) + (1,) * v.ndim)
               for k, v in leaves.items()}
        for name, leaves in one.items()}}


def prefill(params: GenericLM, cfg, batch: dict, max_len: int, *,
            moe_impl: str = "scatter"):
    """Run the prompt; return (last-position logits ``(B, 1, vocab)``,
    filled cache).  ``max_len`` is the cache's, as in :func:`init_cache`."""
    dtype = compute_dtype(cfg)
    x, positions, kw = _context(params, cfg, batch, dtype)
    flags = _moe_flags(cfg)
    caches = {j: [] for j in range(cfg.period)}
    for i, _, j, kind in _layers(cfg):
        x, cache, _ = block_prefill(params.layers[i], cfg, kind, flags[j],
                                    x, positions, max_len,
                                    moe_impl=moe_impl, dtype=dtype, **kw)
        caches[j].append(cache)
    x = apply_norm(params, "norm_f", x, cfg.norm)
    logits = unembed(params, x[:, -1:], cfg.tie_embeddings, dtype)
    return logits, _stack(caches)


def decode_step(params: GenericLM, cfg, cache: dict, tokens, index, *,
                moe_impl: str = "scatter"):
    """One token for the whole batch.  ``tokens``: (B, 1); ``index``: the
    position of every row, a Python int (the attention kinds write their
    cache there and rotate by it; the recurrent kinds carry their
    position in their state)."""
    dtype = compute_dtype(cfg)
    tokens = _on(params, tokens)
    x = embed_lookup(params, tokens, impl=cfg.gather_impl,
                     compute_dtype=dtype)
    if cfg.rope == "none":
        pos = torch.full(tuple(tokens.shape), int(index), dtype=torch.int32,
                         device=x.device)
        x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
    flags = _moe_flags(cfg)
    caches = {j: [] for j in range(cfg.period)}
    for i, p, j, kind in _layers(cfg):
        cc = {k: v[p] for k, v in cache["blocks"][f"b{j}"].items()}
        x, nc = block_step(params.layers[i], cfg, kind, flags[j], x, cc,
                           index, cross=cfg.enc_dec, moe_impl=moe_impl,
                           dtype=dtype)
        caches[j].append(nc)
    x = apply_norm(params, "norm_f", x, cfg.norm)
    return unembed(params, x, cfg.tie_embeddings, dtype), _stack(caches)
