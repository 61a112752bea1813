"""Shared layers of the language-model stack, counterpart of
``repro/models/layers.py``: the parameter tree, dense, norms, embeddings,
the RoPE family (standard, ``rope2d``, M-RoPE) and activations.

Parameters live in :class:`Params` modules keyed by the reference's
names (``ln1_scale``, ``mixer``, ``zifo``, ...), so ``params["zifo"]``
reads as in the reference; the ``apply`` functions are plain functions
on tensors, and also take a nested dict of tensors with the same keys
(what :mod:`repro_torch.models.model` hands them under a mesh).  Each
parameter records the reference's logical sharding axes
(:attr:`Params.specs`; :mod:`repro_torch.dist.sharding`).

Under a tensor-parallel split (:mod:`repro_torch.dist.tp`) the model
hands these functions each rank's blocks: :func:`embed_lookup` gathers
from its block of the vocabulary and reduces the rows over ``tp``,
:func:`unembed` returns its block of the logits; a vocabulary the split
does not divide is whole on every rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.gather_ops import gather as gather_rows
from ..dist import tp

__all__ = ["DTYPES", "Params", "init_dense", "dense", "init_norm",
           "apply_norm", "init_embed", "embed_lookup", "unembed",
           "rope_freqs", "rope_tables", "rope_rotate", "apply_rope",
           "make_positions_mrope",
           "silu", "activation"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Params(nn.Module):
    """A node of the parameter tree, counterpart of the reference's
    ``Param`` helper: :meth:`add` draws a parameter as ``Param.add`` does
    (normal times ``scale``, ``1/sqrt(shape[0])`` by default, drawn in
    float32 and cast to the node's dtype; or zeros; or ones) from one
    :class:`torch.Generator`, and :meth:`sub` adds a child node.

    ``generator=None`` allocates the normal draws without filling them,
    for values loaded afterwards (:mod:`repro_torch.convert`); on the
    ``meta`` device nothing is allocated at all.  :attr:`specs` maps each
    parameter's name to its logical axes, one per dimension, as the
    reference's ``Param.specs`` (``"null"`` or ``None`` replicates).
    Parameters are drawn not requiring gradients, which is what serving
    wants; ``requires_grad_(True)`` on the model makes them trainable, as
    the training launcher and :func:`repro_torch.training.make_train_step`
    do.

    ``place`` (``(tensor, logical axes) -> tensor``) replaces each
    parameter as soon as it is drawn, e.g. by its block on a mesh
    (:func:`repro_torch.models.model.init_model` with ``mesh=``).
    """

    def __init__(self, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator | None = None, place=None):
        super().__init__()
        self._init = (dtype, device, generator, place)
        self.specs: dict[str, tuple] = {}

    def sub(self, name: str) -> "Params":
        child = Params(*self._init)
        self.add_module(name, child)
        return child

    def add(self, name: str, shape, logical_axes=None, *,
            scale: float | None = None,
            init: str = "normal") -> torch.Tensor:
        """Draw parameter ``name`` of ``shape``; ``logical_axes`` (one per
        dimension, replicated where omitted) is recorded in
        :attr:`specs`."""
        self.specs[name] = (tuple(logical_axes) if logical_axes is not None
                            else ("null",) * len(shape))
        dtype, device, generator, place = self._init
        if init == "zeros":
            val = torch.zeros(shape, dtype=dtype, device=device)
        elif init == "ones":
            val = torch.ones(shape, dtype=dtype, device=device)
        elif generator is None:
            val = torch.empty(shape, dtype=dtype, device=device)
        else:
            if scale is None:
                scale = 1.0 / math.sqrt(shape[0])
            val = (torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=device)
                   * scale).to(dtype)
        if place is not None:
            val = place(val, self.specs[name])
        self.register_parameter(name, nn.Parameter(val, requires_grad=False))
        return val

    def __getitem__(self, name: str):
        return getattr(self, name)

    def get(self, name: str, default=None):
        return getattr(self, name, default)


# ----------------------------------------------------------------------
# Dense / norms
# ----------------------------------------------------------------------

def init_dense(p: Params, name: str, d_in: int, d_out: int, logical_axes,
               bias: bool = False):
    p.add(name, (d_in, d_out), logical_axes)
    if bias:
        p.add(name + "_b", (d_out,), (logical_axes[-1],), init="zeros")


def dense(params, name: str, x: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    w = params[name].to(compute_dtype)
    y = x.to(compute_dtype) @ w
    b = params.get(name + "_b")
    if b is not None:
        y = y + b.to(compute_dtype)
    return y


def init_norm(p: Params, name: str, d: int, kind: str = "rmsnorm"):
    p.add(name + "_scale", (d,), ("null",), init="ones")
    if kind == "layernorm":
        p.add(name + "_bias", (d,), ("null",), init="zeros")


def apply_norm(params, name: str, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-5) -> torch.Tensor:
    """RMS or layer norm in float32, as the reference: the layer norm's
    variance is the population variance (``jnp.var``), and its bias is
    added before the scale multiplies."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y + params[name + "_bias"].float()
    y = y * params[name + "_scale"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------------
# Embedding: the gather-strategy consumer
# ----------------------------------------------------------------------

def init_embed(p: Params, vocab: int, d: int, tie: bool):
    # 1/sqrt(d) init + sqrt(d) lookup scaling keeps both the residual
    # stream and (tied) logits at unit scale.
    p.add("embed", (vocab, d), ("tp", "fsdp"), scale=1.0 / math.sqrt(d))
    if not tie:
        p.add("unembed", (d, vocab), ("fsdp", "tp"))


def embed_lookup(params, tokens: torch.Tensor, impl: str = "take",
                 compute_dtype=torch.bfloat16, *, seq: bool = False,
                 vocab: int | None = None) -> torch.Tensor:
    """Token -> vector via the configured gather strategy
    (:mod:`repro_torch.core.gather_ops`), scaled by ``sqrt(d)``.

    The scale is a tensor of the compute dtype, as the reference's
    ``jnp.asarray(math.sqrt(d), compute_dtype)``: in bfloat16 it is
    rounded before it multiplies (a Python float would multiply
    unrounded).  It stays a host scalar, so no copy to the card.

    Under a tensor-parallel split ``params["embed"]`` is this rank's
    block of the vocabulary; the rows (each token's from one rank, zeros
    from the others, so the sum is exact) are all-reduced over ``tp``,
    or with ``seq`` reduce-scattered to this rank's block of the
    sequence.  A ``vocab`` that the split does not divide is whole on
    every rank (the divisibility guard): the one-device gather, and with
    ``seq`` this rank's block of the sequence cut from it."""
    table = params["embed"]
    d = table.shape[1]
    s = tp.vocab_split(vocab)
    if s is None:
        out = tp.leave(gather_rows(table, tokens, impl=impl), tp.split(),
                       False, seq)
    else:
        out = tp.leave(gather_rows(table, tokens, impl=impl,
                                   offset=s.r * table.shape[0],
                                   vocab=s.n * table.shape[0]),
                       s, True, seq)
    return out.to(compute_dtype) * torch.tensor(math.sqrt(d),
                                                dtype=compute_dtype)


def unembed(params, x: torch.Tensor, tie: bool,
            compute_dtype=torch.bfloat16, *, seq: bool = False,
            vocab: int | None = None) -> torch.Tensor:
    """Float32 logits; under a tensor-parallel split this rank's block of
    the vocabulary (column-parallel; with ``seq`` the stream ``x`` is
    this rank's block of the sequence, gathered first), or all of a
    ``vocab`` that the split does not divide."""
    x = tp.enter(x, tp.split(), tp.vocab_split(vocab) is not None, seq)
    if tie:
        w = params["embed"].to(compute_dtype).T
    else:
        w = params["unembed"].to(compute_dtype)
    return (x.to(compute_dtype) @ w).float()


# ----------------------------------------------------------------------
# RoPE family: standard, 2d (ChatGLM), M-RoPE (Qwen2-VL)
# ----------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, rotary_dim: int | None = None, *,
               device=None) -> torch.Tensor:
    """The ``rd / 2`` inverse frequencies ``theta ** -(2i / rd)``, float32;
    ``rd`` is ``rotary_dim`` or ``hd``."""
    rd = rotary_dim or hd
    ex = torch.arange(0, rd, 2, dtype=torch.float32, device=device)
    # A tensor divisor: on a CUDA tensor PyTorch divides by a Python
    # scalar as a multiply by its reciprocal, not as the reference.
    ex = ex / torch.full_like(ex, rd)
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), ex)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope_tables(positions: torch.Tensor, hd: int, theta: float,
                variant: str, dtype: torch.dtype):
    """``(cos, sin, rd)`` of a RoPE variant (see :func:`apply_rope`):
    ``(B, S, 1, rd / 2)`` in ``dtype``, rotating the first ``rd`` dims."""
    dev = positions.device
    if variant == "mrope":
        if positions.ndim != 3:
            raise ValueError("mrope wants (3, B, S) positions")
        rd = hd
        inv = rope_freqs(hd, theta, device=dev)
        n = inv.shape[0]
        s1, s2 = n - 2 * (n // 4), n // 4
        sec = torch.cat([
            torch.zeros((s1,), dtype=torch.int32, device=dev),
            torch.ones((s2,), dtype=torch.int32, device=dev),
            torch.full((n - s1 - s2,), 2, dtype=torch.int32, device=dev)])
        ang_all = positions.to(torch.float32)[..., None] * inv
        ang = ((sec == 0) * ang_all[0] + (sec == 1) * ang_all[1]
               + (sec == 2) * ang_all[2])                 # (B, S, rd/2)
    elif variant in ("standard", "rope2d"):
        rd = hd // 2 if variant == "rope2d" else hd
        inv = rope_freqs(hd, theta, rd, device=dev)
        ang = positions.to(torch.float32)[..., None] * inv  # (B, S, rd/2)
    else:
        raise ValueError(f"unknown rope variant {variant!r}")
    return (torch.cos(ang)[:, :, None, :].to(dtype),
            torch.sin(ang)[:, :, None, :].to(dtype), rd)


def rope_rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """Rotate the first ``rd`` dims of ``x`` (B, S, H, hd) by
    :func:`rope_tables`; the rest pass through."""
    cos, sin, rd = tables
    if rd == x.shape[-1]:
        return _rotate(x, cos, sin)
    return torch.cat([_rotate(x[..., :rd], cos, sin), x[..., rd:]], -1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               hd: int, theta: float, variant: str):
    """Apply a RoPE variant to ``(B, S, H, hd)`` queries and keys.

    ``standard``: full-dim rotary on positions ``(B, S)``.  ``rope2d``
    (ChatGLM): rotary on the first ``hd // 2`` dims with
    ``rope_freqs(hd, theta, hd // 2)``, the rest passes through.
    ``mrope`` (Qwen2-VL): positions ``(3, B, S)``; the frequency dims are
    split 2:1:1 over the (t, h, w) components (t gets the low
    frequencies), which is standard RoPE when the three are equal.
    ``none``/``nope``: the identity.  The angles are float32; ``cos`` and
    ``sin`` are cast to ``q.dtype`` before they rotate, as the
    reference's."""
    if variant in ("none", "nope"):
        return q, k
    tables = rope_tables(positions, hd, theta, variant, q.dtype)
    return rope_rotate(q, tables), rope_rotate(k, tables)


def make_positions_mrope(batch: int, seq: int, n_patches: int = 0,
                         grid: tuple[int, int] | None = None, *,
                         device=None) -> torch.Tensor:
    """(t, h, w) positions ``(3, batch, seq)`` int32: a patch grid
    (t = 0, h and w its row and column) followed by text tokens at t = h
    = w = 1, 2, ...; without patches t = h = w = 0, 1, ..."""
    def iota(n):
        return torch.arange(n, dtype=torch.int32, device=device)

    t = iota(seq)
    if n_patches and grid:
        _, gw = grid
        t_txt = iota(seq - n_patches) + 1
        t = torch.cat([torch.zeros((n_patches,), dtype=torch.int32,
                                   device=device), t_txt])
        h = torch.cat([iota(n_patches) // gw, t_txt])
        w = torch.cat([iota(n_patches) % gw, t_txt])
    else:
        h = w = t
    pos = torch.stack([t, h, w])                          # (3, S)
    return pos[:, None, :].expand(3, batch, seq)


# ----------------------------------------------------------------------
# Activations
# ----------------------------------------------------------------------

def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as written: ``x * sigmoid(x)``, ``sigmoid(x) = 1 /
    (1 + exp(-x))``, each operation rounded to ``x``'s dtype.
    ``F.silu`` rounds once; in bfloat16 that is an ulp off the
    reference's on about a third of the values, and over a deep stack
    enough to flip an MoE router's choice."""
    return x * (1 / (1 + torch.exp(-x)))


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def activation(name: str):
    if name == "swiglu":                  # handled in mlp (two inputs)
        return silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":                   # Nemotron-4 squared ReLU
        return _relu2
    raise ValueError(name)
