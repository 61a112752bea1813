"""Shared layers of the language-model stack, counterpart of
``repro/models/layers.py``: the parameter tree, dense, norms, embeddings
and activations.  RoPE comes with the attention slice.

Parameters live in :class:`Params` modules keyed by the reference's
names (``ln1_scale``, ``mixer``, ``zifo``, ...), so ``params["zifo"]``
reads as in the reference; the ``apply`` functions are plain functions
on tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.gather_ops import gather as gather_rows

__all__ = ["DTYPES", "Params", "init_dense", "dense", "init_norm",
           "apply_norm", "init_embed", "embed_lookup", "unembed",
           "activation"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Params(nn.Module):
    """A node of the parameter tree, counterpart of the reference's
    ``Param`` helper: :meth:`add` draws a parameter as ``Param.add`` does
    (normal times ``scale``, ``1/sqrt(shape[0])`` by default, drawn in
    float32 and cast to the node's dtype; or zeros; or ones) from one
    :class:`torch.Generator`, and :meth:`sub` adds a child node.

    ``generator=None`` allocates the normal draws without filling them,
    for values loaded afterwards (:mod:`repro_torch.convert`).
    Parameters do not require gradients: the port serves, it does not
    train yet.
    """

    def __init__(self, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self._init = (dtype, device, generator)

    def sub(self, name: str) -> "Params":
        child = Params(*self._init)
        self.add_module(name, child)
        return child

    def add(self, name: str, shape, *, scale: float | None = None,
            init: str = "normal") -> torch.Tensor:
        dtype, device, generator = self._init
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
        self.register_parameter(name, nn.Parameter(val, requires_grad=False))
        return val

    def __getitem__(self, name: str):
        return getattr(self, name)

    def get(self, name: str, default=None):
        return getattr(self, name, default)


# ----------------------------------------------------------------------
# Dense / norms
# ----------------------------------------------------------------------

def init_dense(p: Params, name: str, d_in: int, d_out: int,
               bias: bool = False):
    p.add(name, (d_in, d_out))
    if bias:
        p.add(name + "_b", (d_out,), init="zeros")


def dense(params, name: str, x: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    w = params[name].to(compute_dtype)
    y = x.to(compute_dtype) @ w
    b = params.get(name + "_b")
    if b is not None:
        y = y + b.to(compute_dtype)
    return y


def init_norm(p: Params, name: str, d: int, kind: str = "rmsnorm"):
    p.add(name + "_scale", (d,), init="ones")
    if kind == "layernorm":
        p.add(name + "_bias", (d,), init="zeros")


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
    p.add("embed", (vocab, d), scale=1.0 / math.sqrt(d))
    if not tie:
        p.add("unembed", (d, vocab))


def embed_lookup(params, tokens: torch.Tensor, impl: str = "take",
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Token -> vector via the configured gather strategy
    (:mod:`repro_torch.core.gather_ops`), scaled by ``sqrt(d)``.

    The scale is a tensor of the compute dtype, as the reference's
    ``jnp.asarray(math.sqrt(d), compute_dtype)``: in bfloat16 it is
    rounded before it multiplies (a Python float would multiply
    unrounded).  It stays a host scalar, so no copy to the card."""
    table = params["embed"]
    d = table.shape[1]
    out = gather_rows(table, tokens, impl=impl)
    return out.to(compute_dtype) * torch.tensor(math.sqrt(d),
                                                dtype=compute_dtype)


def unembed(params, x: torch.Tensor, tie: bool,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    if tie:
        w = params["embed"].to(compute_dtype).T
    else:
        w = params["unembed"].to(compute_dtype)
    return (x.to(compute_dtype) @ w).float()


# ----------------------------------------------------------------------
# Activations
# ----------------------------------------------------------------------

def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def activation(name: str):
    if name == "swiglu":                  # handled in mlp (two inputs)
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":                   # Nemotron-4 squared ReLU
        return _relu2
    raise ValueError(name)
