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

Entry points, as the reference's:

* :func:`init_model`   -> :class:`GenericLM`, drawn from a seed
* :func:`forward`      -> (logits, aux loss); ``remat=True`` recomputes
  each period's activations in the backward, as the reference's
  ``jax.checkpoint`` of its scanned period
* :func:`loss_fn`      -> (LM loss + aux, metrics), what training
  differentiates (:mod:`repro_torch.training`)
* :func:`prefill`      -> (last-token logits, filled cache)
* :func:`decode_step`  -> (logits, cache)
* :func:`init_cache`   -> decode cache

MoE replaces the MLP in the pattern slots :func:`_moe_flags` names
(``moe_impl`` chooses its dispatch, as the reference's).

Parameter specs and the facade, as the reference's: :func:`param_specs`
(each parameter's logical sharding axes, from a model on the ``meta``
device: nothing is allocated), :func:`abstract_params` (that model, the
counterpart of ``jax.eval_shape``), :class:`Model` and
:func:`build_model`.  A block leaf's spec is the reference's without its
leading ``"null"``: the port keeps one module per layer, not a stack.

**Under a mesh.**  Inside a :func:`repro_torch.dist.sharding_context`
whose mesh has more than one rank, every entry point runs SPMD, data
parallel over the ``batch`` axes with the parameters placed (ZeRO-3
over ``fsdp``) as they are drawn, by :func:`init_model` with ``mesh=``,
or, for parameters converted from the reference, afterwards by
:func:`repro_torch.dist.place_params`:

* each rank takes its block of the batch's rows; a batch that the batch
  shards do not divide is replicated over them, the call running with
  no batch axes (:func:`_guard`; the reference's ``pick_rules`` drops
  ``batch`` for such a cell), so no gradient is summed over ranks that
  hold equal rows;
* the top-level parameters are gathered once a call, each layer's
  inside its period, so under remat the gathered copies are freed after
  the period and gathered again in the backward; the model's code, and
  the hand-written kernels, see plain full tensors only
  (:func:`repro_torch.dist.fsdp.gather`);
* :func:`loss_fn` divides the local sum by the all-reduced count of
  labelled tokens, so its value is the global mean and each rank's
  gradient its part of it; :func:`forward`, :func:`prefill` and
  :func:`decode_step` return the full logits (every rank's rows);
* the cache is this rank's: its batch rows and, under flash-decoding
  (``rules.flash_decode`` with ``sp`` axes), its slice of the positions
  (:func:`init_cache`, :func:`prefill`, :func:`shard_cache`).  A
  ``max_len`` that the sequence shards do not divide falls back to the
  plain decode, as the reference's (``repro/models/attention.py``): the
  positions stay whole on every rank, and the cache says so
  (:data:`WHOLE_POSITIONS`) for :func:`decode_step`;
* under a tensor-parallel split (``tp`` on mesh dimensions above size
  1; :mod:`repro_torch.dist.tp`) each rank computes only its heads,
  channels, FFN columns and block of the vocabulary: :class:`_Gathered`
  reads each ``tp``-split parameter as the rank's block (the fused
  projections part by part), the blocks enter and leave each sub-layer
  through the Megatron operators, the loss is the vocabulary-parallel
  cross-entropy, and :func:`forward`, :func:`prefill` and
  :func:`decode_step` gather the vocabulary blocks; the cache holds the
  rank's KV heads, channels and units; a sub-layer, or the
  vocabulary, whose widths the split does not divide runs whole on every
  rank (:func:`repro_torch.dist.tp.sub_split`, the reference's
  divisibility guard);
* where ``rules.sp_act`` resolves to ``tp``'s mesh dimensions, the
  residual stream of the full-sequence paths is the rank's block of the
  sequence between sub-layers (the reference's ``shard_constraint`` on
  ``sp_act``), and the norms' gradients are summed over it; a sequence
  the ranks do not divide runs whole.

A mesh of one rank runs the one-device code exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..dist import fsdp, tp
from ..dist.sharding import current, sharding_context
from .attention import sp_shards
from .blocks import (block_forward, block_prefill, block_step, init_block,
                     init_block_cache)
from .layers import (DTYPES, Params, apply_norm, dense, embed_lookup,
                     init_dense, init_embed, init_norm, make_positions_mrope,
                     unembed)
from .moe import ep_shards, gather_moe

__all__ = ["FRONTEND_DIM", "GenericLM", "init_model", "forward", "loss_fn",
           "prefill", "decode_step", "init_cache", "shard_cache",
           "param_specs", "abstract_params", "Model", "build_model",
           "WHOLE_POSITIONS"]

# Stub modality frontends: precomputed features -> linear adapter.
FRONTEND_DIM = {"audio": 80, "vision": 1176}
# The key of a cache whose KV positions are whole on every rank where
# flash-decoding is on (its shards do not divide ``max_len``); an empty
# dict, so that code mapping over a cache's tensors passes it through.
WHOLE_POSITIONS = "whole_positions"


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
                 generator: torch.Generator | None, place=None):
        super().__init__(compute_dtype(cfg), device, generator, place)
        self.cfg = cfg
        init_embed(self, cfg.vocab, cfg.d_model, cfg.tie_embeddings)
        init_norm(self, "norm_f", cfg.d_model, cfg.norm)
        if cfg.frontend:
            init_dense(self, "frontend", FRONTEND_DIM[cfg.frontend],
                       cfg.d_model, ("null", "fsdp"))
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
               device="cuda", mesh=None, rules=None) -> GenericLM:
    """A :class:`GenericLM` on ``device`` (the card by default), drawn
    from ``generator`` or, without one, from a generator seeded with
    ``seed``.  With a ``mesh`` of more than one rank (and its ``rules``)
    each parameter is placed as soon as it is drawn
    (:func:`repro_torch.dist.fsdp.place`): the values of
    :func:`repro_torch.dist.place_params` after a whole draw, with at
    most one whole parameter held at a time."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    place = None
    if mesh is not None and mesh.size() > 1:
        def place(t, axes):
            return fsdp.place(t, axes, mesh, rules)
    return GenericLM(cfg, device=dev, generator=generator, place=place)


def _specs_of(model: nn.Module) -> dict:
    """``{parameter name: logical axes}`` of a model's :class:`Params`."""
    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, Params):
            for leaf, spec in mod.specs.items():
                out[f"{prefix}.{leaf}" if prefix else leaf] = spec
    return out


def abstract_params(cfg) -> GenericLM:
    """The model's parameters on the ``meta`` device: their names, shapes
    and dtypes, with nothing allocated (the counterpart of the
    reference's ``jax.eval_shape`` of its init)."""
    return GenericLM(cfg, device=torch.device("meta"), generator=None)


def param_specs(cfg) -> dict:
    """``{parameter name: logical axes}`` without allocating parameters
    (a block leaf's spec is the reference's without its leading
    ``"null"``)."""
    return _specs_of(abstract_params(cfg))


class Model:
    """Thin facade bundling (cfg, params, specs) for launchers."""

    def __init__(self, cfg, params, specs):
        self.cfg = cfg
        self.params = params
        self.specs = specs

    def __repr__(self):
        n = self.cfg.param_count()
        return (f"Model({self.cfg.name}, {n / 1e6:.1f}M params, "
                f"family={self.cfg.family})")


def build_model(cfg, *, seed: int = 0, device="cuda") -> Model:
    """A :class:`Model` drawn from ``seed`` on ``device``."""
    params = init_model(cfg, seed=seed, device=device)
    return Model(cfg, params, _specs_of(params))


def _on(params: GenericLM, x, dtype=torch.int64) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=params.device)


class _Gathered:
    """A placed :class:`GenericLM` as the model's code reads it under a
    mesh: its top-level parameters gathered at once, each layer when it
    is read (inside its period's remat region), as nested dicts of
    tensors.  Under expert parallelism a MoE layer keeps its own experts
    only, and its router's gradient is summed over the ``ep`` axes (each
    rank's covers its experts).  Under a tensor-parallel split each
    parameter is read as :func:`repro_torch.dist.tp.read` gives it (the
    rank's block; ``seq``: the stream is split along the sequence)."""

    def __init__(self, model: GenericLM, mesh, rules, ep: bool,
                 seq: bool = False):
        cfg = model.cfg
        self.device = model.device
        # The layers read through a partial of the module-level
        # functions, not a bound method: no reference cycle keeps the
        # model alive past its last use.
        at = (mesh, rules, ep, cfg, tp.split(), seq)
        self._top = _own(at, model, "top")
        self.layers = _LazyLayers(
            model.layers, functools.partial(_full, at),
            lambda i: cfg.block_pattern[i % cfg.period])
        if cfg.enc_dec:
            self.enc_layers = _LazyLayers(model.enc_layers,
                                          functools.partial(_full, at),
                                          lambda i: "attn")

    def __getitem__(self, name: str):
        return self._top[name]

    def get(self, name: str, default=None):
        return self._top.get(name, default)


def _own(at: tuple, module: nn.Module, kind: str) -> dict:
    """A module's own parameters as :class:`_Gathered` reads them."""
    mesh, rules, _, cfg, s, seq = at
    if s is None:
        return {n: fsdp.gather(p, mesh, rules)
                for n, p in module.named_parameters(recurse=False)}
    return {n: tp.read(p, n, module.specs[n], kind, cfg, mesh, rules, s,
                       seq)
            for n, p in module.named_parameters(recurse=False)}


def _full(at: tuple, module: nn.Module, kind: str) -> dict:
    """A block's parameters; ``kind`` its mixer's."""
    mesh, rules, ep, *_ = at
    out = _own(at, module, "block")
    for n, child in module.named_children():
        if n == "moe":
            out[n] = gather_moe(child, mesh, rules, ep)
        else:
            out[n] = _own(at, child, kind if n == "mixer" else n)
    return out


class _LazyLayers:
    def __init__(self, layers: nn.ModuleList, full, kind):
        self._layers, self._full, self._kind = layers, full, kind

    def __getitem__(self, i: int) -> dict:
        return self._full(self._layers[i], self._kind(i))

    def __iter__(self):
        return (self[i] for i in range(len(self._layers)))


def _read(params: GenericLM, cfg, moe_impl: str = "scatter",
          seq: bool = False):
    """``params`` as the code reads it: the model itself off a mesh,
    a :class:`_Gathered` view under one."""
    ctx = fsdp.active()
    if ctx is None:
        return params
    return _Gathered(params, *ctx,
                     ep=moe_impl == "ep" and ep_shards(cfg) is not None,
                     seq=seq)


def _seq_split(cfg, batch: dict) -> tuple:
    """``(split, seq)``: the tensor-parallel split, and whether the
    full-sequence paths split the stream along the sequence: where
    ``sp_act`` lies on ``tp``'s mesh dimensions and the ranks divide the
    sequence (the patches and tokens of a vision model; also the frames
    of an encoder-decoder), else the stream is whole."""
    s = tp.split()
    if s is None or not s.sp:
        return s, False
    def length(k):
        return torch.as_tensor(batch[k]).shape[1]

    n = length("tokens")
    if cfg.frontend == "vision" and "patches" in batch:
        n += length("patches")
    lens = [n] + ([length("frames")] if cfg.enc_dec else [])
    return s, all(tp.divides(m, s) for m in lens)


def _whole_positions(max_len: int) -> bool:
    """Whether flash-decoding is on but its sequence shards do not divide
    ``max_len``: the reference falls back to the plain decode there
    (``repro/models/attention.py``), and so does the port, with the KV
    cache's positions whole on every rank."""
    sp = sp_shards()
    return sp is not None and max_len % sp[2] != 0


@contextlib.contextmanager
def _guard(rows: int, whole_positions: bool = False):
    """One entry point's call under the reference's divisibility guard:
    where the batch shards do not divide its ``rows`` the batch is
    replicated (the rules lose their ``batch`` axes, as the reference's
    ``pick_rules`` drops them: every rank runs every row, no gradient is
    summed over ranks that hold equal rows, and the loss needs no
    reduction), and with ``whole_positions`` flash-decoding is off (the
    plain decode, the attention split over ``tp`` as without it)."""
    ctx = fsdp.active()
    over = {}
    if ctx is not None:
        mesh, rules = ctx
        if rows % math.prod(mesh.size(i)
                            for i in fsdp.batch_dims(mesh, rules)):
            over["batch"] = ()
        if whole_positions:
            over["flash_decode"] = False
    if not over:
        yield
        return
    with sharding_context(mesh, dataclasses.replace(rules, **over)):
        yield


def _marked(cache: dict, whole_positions: bool) -> dict:
    """``cache``, with :data:`WHOLE_POSITIONS` where its positions are
    whole under flash-decoding's rules."""
    return dict(cache, **{WHOLE_POSITIONS: {}}) if whole_positions \
        else cache


def _rows(batch: dict, device) -> dict:
    """This rank's rows of each batch entry under a mesh; ``batch``
    itself off one."""
    ctx = fsdp.active()
    if ctx is None:
        return batch
    return {k: fsdp.batch_block(torch.as_tensor(v, device=device), *ctx)
            for k, v in batch.items()}


def _all_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` under a mesh; ``t`` off one."""
    ctx = fsdp.active()
    return t if ctx is None else fsdp.gather_rows(t, *ctx)


def _keep_context(fn):
    """``fn`` under the sharding context active now, also where autograd
    recomputes it (remat) on the engine's device thread, which a context
    variable does not reach."""
    ctx = current()
    if ctx is None:
        return fn

    def run(*args):
        with sharding_context(*ctx):
            return fn(*args)

    return run


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


def _embed_inputs(params: GenericLM, cfg, batch: dict, dtype,
                  seq: bool = False):
    """(x, positions): the token embeddings, after the projected patches
    of a vision model (with their M-RoPE grid positions); positions
    ``(B, S)``, or ``(3, B, S)`` under M-RoPE; sinusoids added under
    ``rope="none"``.  With ``seq`` (``sp_act``) ``x`` is this rank's
    block of the sequence; the positions are the whole sequence's."""
    tokens = _on(params, batch["tokens"])
    B = tokens.shape[0]
    s = tp.split() if seq else None
    vision = cfg.frontend == "vision" and "patches" in batch
    x = embed_lookup(params, tokens, impl=cfg.gather_impl,
                     compute_dtype=dtype, seq=seq and not vision,
                     vocab=cfg.vocab)
    if vision:
        patches = dense(params, "frontend",
                        _on(params, batch["patches"], torch.float32), dtype)
        x = torch.cat([patches, x], dim=1)
        n_img = patches.shape[1]
        g = max(1, int(math.sqrt(n_img)))
        positions = make_positions_mrope(B, x.shape[1], n_img,
                                         (g, max(1, n_img // g)),
                                         device=x.device)
        return tp.leave(x, s, False, seq), positions
    S = tokens.shape[1]
    pos = torch.arange(S, dtype=torch.int32,
                       device=x.device).expand(B, S)
    positions = pos.expand(3, B, S) if cfg.rope == "mrope" else pos
    if cfg.rope == "none":
        own = pos
        if seq:
            off, n = tp.block_of(S, s, "the sequence (sp_act)")
            own = pos[:, off:off + n]
        x = x + _sinusoid(own, cfg.d_model).to(x.dtype)
    return x, positions


def _encode(params: GenericLM, cfg, batch: dict, dtype, seq: bool):
    """The encoder stack over ``batch["frames"]`` (B, S, FRONTEND_DIM):
    (encoder output, its positions); with ``seq`` the output is this
    rank's block of the sequence."""
    x = dense(params, "frontend", _on(params, batch["frames"],
                                      torch.float32), dtype)
    B, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
    if seq:
        x = tp.leave(x, tp.split(), False, True)
    for block in params.enc_layers:
        x, _ = block_forward(block, cfg, "attn", False, x, pos,
                             causal=False, dtype=dtype, seq=seq)
    return apply_norm(params, "norm_enc", x, cfg.norm), pos


def _context(params, cfg, batch, dtype, seq: bool = False):
    """The embedded inputs and, for an encoder-decoder, the keyword
    arguments its decoder blocks take."""
    x, positions = _embed_inputs(params, cfg, batch, dtype, seq)
    kw = {"cross": cfg.enc_dec, "seq": seq}
    if cfg.enc_dec:
        kw["enc_out"], kw["enc_positions"] = _encode(params, cfg, batch,
                                                     dtype, seq)
    return x, positions, kw


# ----------------------------------------------------------------------
# Forward / serving
# ----------------------------------------------------------------------

def _period(params: GenericLM, cfg, p: int, positions, kw: dict,
            moe_impl: str, dtype, x: torch.Tensor):
    """The blocks of period ``p`` on ``x``: (x, the period's aux loss)."""
    flags = _moe_flags(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, kind in enumerate(cfg.block_pattern):
        x, a = block_forward(params.layers[p * cfg.period + j], cfg, kind,
                             flags[j], x, positions, moe_impl=moe_impl,
                             dtype=dtype, **kw)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(params: GenericLM, cfg, batch: dict, *,
            moe_impl: str = "scatter", remat: bool = True):
    """Logits ``(B, S, vocab)`` float32 and the auxiliary loss (the MoE
    layers' load-balance losses summed, as the reference: per period,
    then over periods; 0 without MoE) for ``batch["tokens"]`` ``(B, S)``
    (plus ``patches`` or ``frames`` for the frontends).

    With ``remat`` (the reference's default), gradients enabled and
    trainable parameters, each period runs under
    ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward, as the reference's ``jax.checkpoint`` of its scanned
    period.  The values are the same either way."""
    with _guard(len(batch["tokens"])):
        logits, aux = _forward(params, cfg, _rows(batch, params.device),
                               moe_impl, remat)
        return _all_rows(tp.full_vocab(logits,
                                       tp.vocab_split(cfg.vocab))), aux


def _forward(params: GenericLM, cfg, batch: dict, moe_impl: str,
             remat: bool):
    """:func:`forward` on this rank's rows: its logits (its block of the
    vocabulary under a tensor-parallel split) and the aux loss."""
    dtype = compute_dtype(cfg)
    remat = remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())
    _, seq = _seq_split(cfg, batch)
    params = _read(params, cfg, moe_impl, seq)
    x, positions, kw = _context(params, cfg, batch, dtype, seq)
    auxs = []
    for p in range(cfg.n_periods):
        body = _keep_context(functools.partial(
            _period, params, cfg, p, positions, kw, moe_impl, dtype))
        if remat:
            x, a = checkpoint(body, x, use_reentrant=False)
        else:
            x, a = body(x)
        auxs.append(a)
    x = apply_norm(params, "norm_f", x, cfg.norm)
    return (unembed(params, x, cfg.tie_embeddings, dtype, seq=seq,
                    vocab=cfg.vocab),
            torch.stack(auxs).sum())


def loss_fn(params: GenericLM, cfg, batch: dict, *, aux_weight: float = 0.01,
            moe_impl: str = "scatter", remat: bool = True):
    """The mean next-token negative log-likelihood over ``batch["labels"]``
    ``(B, S)`` (labels < 0 masked out; a vision model's labels padded
    with -1 over its patch positions), from a float32 ``log_softmax``,
    plus ``aux_weight`` times the auxiliary loss.  Returns ``(loss,
    {"lm_loss", "aux_loss"})``, as the reference's.  Under a mesh the
    value is the global mean and each rank differentiates its part."""
    with _guard(len(batch["tokens"])):
        return _loss(params, cfg, _rows(batch, params.device), aux_weight,
                     moe_impl, remat)


def _loss(params: GenericLM, cfg, batch: dict, aux_weight: float,
          moe_impl: str, remat: bool):
    """:func:`loss_fn` on this rank's rows."""
    logits, aux = _forward(params, cfg, batch, moe_impl, remat)
    labels = _on(params, batch["labels"])
    if logits.shape[1] != labels.shape[1]:      # vlm: patch positions
        labels = F.pad(labels, (logits.shape[1] - labels.shape[1], 0),
                       value=-1)
    mask = (labels >= 0).to(torch.float32)
    safe = labels.clamp_min(0)
    s = tp.vocab_split(cfg.vocab)
    if s is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    else:
        nll = tp.vocab_nll(logits, safe, s)
    count = torch.sum(mask)
    ctx = fsdp.active()
    dims = () if ctx is None else fsdp.batch_dims(ctx[0], ctx[1])
    if dims:
        count = fsdp.reduced(count, ctx[0], dims)
    loss = torch.sum(nll * mask) / torch.clamp_min(count, 1.0)
    if dims:
        loss = fsdp.reduced(loss, ctx[0], dims)
    return loss + aux_weight * aux, {"lm_loss": loss, "aux_loss": aux}


def _cache_rows(batch: int) -> int:
    """This rank's rows of a cache of ``batch`` sequences: all of them
    where the batch shards do not divide them (:func:`_guard`)."""
    ctx = fsdp.active()
    if ctx is None:
        return batch
    n = math.prod(ctx[0].size(i) for i in fsdp.batch_dims(*ctx))
    return batch if batch % n else batch // n


def init_cache(cfg, batch: int, max_len: int, enc_len: int = 0, *,
               device="cuda") -> dict:
    """The decode cache of ``batch`` sequences: ``max_len`` positions of
    each attention block's KV cache (the recurrent states have no time
    axis) and ``enc_len`` of the encoder's keys and values.  Under a mesh
    it is this rank's: its rows, its KV heads, channels and units under a
    tensor-parallel split and, under flash-decoding, its slice of the
    positions (nothing else is allocated; a ``max_len`` its shards do not
    divide keeps them whole, :data:`WHOLE_POSITIONS`)."""
    dev = resolve_device(device)
    dtype = compute_dtype(cfg)
    whole = _whole_positions(max_len)
    with _guard(batch, whole):
        one = {f"b{j}": init_block_cache(
                   cfg, kind, _cache_rows(batch),
                   _cache_len(max_len) if kind == "attn" else max_len,
                   cross=cfg.enc_dec, enc_len=enc_len, dtype=dtype,
                   device=dev)
               for j, kind in enumerate(cfg.block_pattern)}
    return _marked({"blocks": {
        name: {k: v.unsqueeze(0).repeat((cfg.n_periods,) + (1,) * v.ndim)
               for k, v in leaves.items()}
        for name, leaves in one.items()}}, whole)


_KV = ("k", "v", "k_s", "v_s")


def _cache_len(max_len: int) -> int:
    """This rank's positions of a KV cache of ``max_len``: its slice
    under flash-decoding, or all of them where its sequence shards do
    not divide ``max_len`` (the plain decode, :func:`_whole_positions`)."""
    sp = sp_shards()
    if sp is None or max_len % sp[2]:
        return max_len
    return max_len // sp[2]


# The tensor-parallel dimension of each stacked cache leaf ``(periods,
# rows, ...)``: ``kv`` leaves follow the KV heads, ``heads`` the mLSTM
# heads, the others the channels (units).
_SPLIT_DIM = {"attn": {k: (3, "kv") for k in _KV},
              "mamba": {"conv": (3, "di"), "h": (2, "di")},
              "mlstm": {"C": (2, "heads"), "n": (2, "heads"),
                        "m": (2, "heads")},
              "slstm": {k: (2, "di") for k in "cnhm"}}


def _tp_cut(cfg, kind: str, k: str, v: torch.Tensor, s) -> torch.Tensor:
    """This rank's block of a full stacked cache leaf ``k`` of a
    ``kind`` block under the split ``s``."""
    if k in ("cross_k", "cross_v"):
        dim, unit = 3, "kv"
    elif k in _SPLIT_DIM[kind]:
        dim, unit = _SPLIT_DIM[kind][k]
    else:
        return v
    sub = tp.sub_split(cfg, "attn" if unit == "kv" else kind, s)
    if sub is None:                     # the sub-layer runs whole
        return v
    if unit == "kv":
        k0, k1 = tp.kv_heads(cfg, sub)
        return v.narrow(dim, k0, k1 - k0)
    off, size = tp.block_of(v.shape[dim], sub, f"{kind} cache leaf {k!r}")
    return v.narrow(dim, off, size)


def _keep_block(cfg, cache: dict, rows: bool) -> dict:
    """This rank's block of a cache: with ``rows`` (a full cache) its
    rows and its tensor-parallel block; under flash-decoding, its slice
    of the KV caches' positions."""
    ctx = fsdp.active()
    if ctx is None:
        return cache
    sp = sp_shards()
    s = tp.split() if rows else None
    out = {}
    for j, kind in enumerate(cfg.block_pattern):
        leaves = {}
        for k, v in cache["blocks"][f"b{j}"].items():
            if rows:
                v = fsdp.batch_block(v, *ctx, d=1)
            if s is not None:
                v = _tp_cut(cfg, kind, k, v, s)
            if sp is not None and kind == "attn" and k in _KV:
                T = _cache_len(v.shape[2])
                v = v.narrow(2, fsdp.axes_offset(sp[0], sp[1], T), T)
            leaves[k] = v.contiguous()
        out[f"b{j}"] = leaves
    return {"blocks": out}


def shard_cache(cfg, cache: dict) -> dict:
    """This rank's block of a full cache (every rank's identical copy,
    e.g. from :func:`prefill` outside the context): its rows, its KV
    heads, channels and units under a tensor-parallel split and, under
    flash-decoding, its slice of each KV cache's positions (the
    divisibility guard as in :func:`init_cache`).  Off a mesh, ``cache``
    itself."""
    leaves = [(j, k, v) for j, kind in enumerate(cfg.block_pattern)
              for k, v in cache["blocks"][f"b{j}"].items()]
    kv = [v for j, k, v in leaves
          if cfg.block_pattern[j] == "attn" and k == "k"]
    whole = bool(kv) and _whole_positions(kv[0].shape[2])
    with _guard(leaves[0][2].shape[1], whole):
        return _marked(_keep_block(cfg, cache, rows=True), whole)


def prefill(params: GenericLM, cfg, batch: dict, max_len: int, *,
            moe_impl: str = "scatter"):
    """Run the prompt; return (last-position logits ``(B, 1, vocab)``,
    filled cache).  ``max_len`` is the cache's, as in :func:`init_cache`
    (under a mesh the cache is this rank's, as there)."""
    whole = _whole_positions(max_len)
    with _guard(len(batch["tokens"]), whole):
        logits, cache = _prefill(params, cfg, _rows(batch, params.device),
                                 max_len, moe_impl)
    return logits, _marked(cache, whole)


def _prefill(params: GenericLM, cfg, batch: dict, max_len: int,
             moe_impl: str):
    """:func:`prefill` on this rank's rows."""
    dtype = compute_dtype(cfg)
    s, seq = _seq_split(cfg, batch)
    params = _read(params, cfg, moe_impl, seq)
    x, positions, kw = _context(params, cfg, batch, dtype, seq)
    flags = _moe_flags(cfg)
    caches = {j: [] for j in range(cfg.period)}
    for i, _, j, kind in _layers(cfg):
        x, cache, _ = block_prefill(params.layers[i], cfg, kind, flags[j],
                                    x, positions, max_len,
                                    moe_impl=moe_impl, dtype=dtype, **kw)
        caches[j].append(cache)
    x = tp.seq_full(apply_norm(params, "norm_f", x, cfg.norm), s, seq)
    logits = unembed(params, x[:, -1:], cfg.tie_embeddings, dtype,
                     vocab=cfg.vocab)
    return (_all_rows(tp.full_vocab(logits, tp.vocab_split(cfg.vocab))),
            _keep_block(cfg, _stack(caches), rows=False))


def decode_step(params: GenericLM, cfg, cache: dict, tokens, index, *,
                moe_impl: str = "scatter"):
    """One token for the whole batch.  ``tokens``: (B, 1); ``index``: the
    position of every row, a Python int (the attention kinds write their
    cache there and rotate by it; the recurrent kinds carry their
    position in their state).  Under a mesh ``cache`` is this rank's
    (:func:`init_cache`) and the logits are every rank's rows."""
    whole = WHOLE_POSITIONS in cache
    with _guard(len(tokens), whole):
        logits, cache = _decode(params, cfg, cache, tokens, index,
                                moe_impl)
    return logits, _marked(cache, whole)


def _decode(params: GenericLM, cfg, cache: dict, tokens, index,
            moe_impl: str):
    """:func:`decode_step` on this rank's rows."""
    dtype = compute_dtype(cfg)
    tokens = _rows({"tokens": _on(params, tokens)}, params.device)["tokens"]
    params = _read(params, cfg, moe_impl)
    x = embed_lookup(params, tokens, impl=cfg.gather_impl,
                     compute_dtype=dtype, vocab=cfg.vocab)
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
    logits = unembed(params, x, cfg.tie_embeddings, dtype, vocab=cfg.vocab)
    return (_all_rows(tp.full_vocab(logits, tp.vocab_split(cfg.vocab))),
            _stack(caches))
