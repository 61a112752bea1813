"""GQA attention, counterpart of ``repro/models/attention.py``: full-
sequence attention (dense, or an online softmax over KV blocks above
``cfg.attn_chunk`` keys) and one-token decode against a KV cache in
bfloat16 (the compute dtype) or int8 with per-(token, head) scales.

Entry points sharing one parameter set, as the reference's:

* :func:`attention_train`      — full sequence, self- or cross-attention
* :func:`attention_decode`     — one token: update the cache at ``index``
  and attend to the prefix
* :func:`attention_cross_step` — one token against precomputed encoder
  keys and values (whisper)

Each path keeps the reference's order of operations: the dense path
scales the float32 logits after the QK product and casts the
probabilities to ``v``'s dtype before the PV product; the chunked path
folds the scale into ``q`` and stays in float32 until the result.  The
mask value is ``-1e30``, not ``-inf``.  The reference's
``shard_constraint`` is the identity without a mesh and its
sequence-parallel decode (``_decode_attend_sp``) runs only under one, so
neither has a counterpart here (ROADMAP Queue 1, item 8).  The port
writes no attention kernel: the reference's attention is jnp code, not a
Pallas kernel.

Under a tensor-parallel split (:mod:`repro_torch.dist.tp`) the
functions take a rank's blocks of ``wq``/``wk``/``wv`` and ``wo`` and
compute its query heads and the KV heads those read (the head counts
come from the weights' widths, the cache's from :func:`tp.local_kv`;
query heads that straddle GQA groups unevenly read theirs through
:func:`tp.head_map`); ``wo``'s output is the rank's partial sum, which
the block reduces.  Where the split does not divide the heads the
attention runs whole on every rank.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..dist import fsdp, tp
from .layers import Params, dense, init_dense, rope_rotate, rope_tables

__all__ = ["init_attention", "attention_train", "attention_decode",
           "attention_cross_step", "init_kv_cache", "sp_shards"]

_NEG = -1e30


def init_attention(p: Params, cfg, cross: bool = False):
    d, hd = cfg.d_model, cfg.hd
    init_dense(p, "wq", d, cfg.n_heads * hd, ("fsdp", "tp"),
               bias=cfg.qkv_bias)
    init_dense(p, "wk", d, cfg.n_kv_heads * hd, ("fsdp", "tp"),
               bias=cfg.qkv_bias)
    init_dense(p, "wv", d, cfg.n_kv_heads * hd, ("fsdp", "tp"),
               bias=cfg.qkv_bias)
    init_dense(p, "wo", cfg.n_heads * hd, d, ("tp", "fsdp"))


def _rope_one(t: torch.Tensor, positions, cfg) -> torch.Tensor:
    """The configured RoPE variant on one ``(B, S, H, hd)`` tensor (the
    reference's ``apply_rope(t, t, ...)[0]``, without rotating a second
    copy)."""
    if positions is None or cfg.rope in ("none", "nope"):
        return t
    return rope_rotate(t, rope_tables(positions, cfg.hd, cfg.rope_theta,
                                      cfg.rope, t.dtype))


def _qkv(params, cfg, xq, xkv, positions, kv_positions, dtype):
    """Rotated queries and keys, and values, ``(B, S, heads, hd)``: the
    heads this rank's weights hold (all off a split)."""
    B, S = xq.shape[:2]
    T = xkv.shape[1]
    hd = cfg.hd
    q = dense(params, "wq", xq, dtype).reshape(B, S, -1, hd)
    k = dense(params, "wk", xkv, dtype).reshape(B, T, -1, hd)
    v = dense(params, "wv", xkv, dtype).reshape(B, T, -1, hd)
    return (_rope_one(q, positions, cfg), _rope_one(k, kv_positions, cfg),
            v)


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, KV, G, hd) with G = H // KV: query head h
    reads KV head h // G."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def _heads(cfg, q, k, v):
    """``(q grouped over the KV heads it reads, k, v)``.  Where this
    rank's query heads straddle GQA groups unevenly
    (:func:`repro_torch.dist.tp.head_map`) each query head gets its own
    copy of its KV head's keys and values, one group a head."""
    s = tp.sub_split(cfg, "attn", tp.split())
    heads = None if s is None else tp.head_map(cfg, s)
    if heads is None:
        return _group(q, k.shape[2]), k, v
    idx = torch.tensor(heads, device=k.device)
    return (_group(q, q.shape[2]), k.index_select(2, idx),
            v.index_select(2, idx))


def _scale(hd: int) -> float:
    """``1 / sqrt(hd)`` rounded as the reference's float32 ``1 /
    sqrt(hd)``; a Python float, so that no copy to the card waits for
    it (a float32 tensor times a Python float multiplies in float32)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _causal_mask(S: int, T: int, q_offset, k_offset: int, device):
    qi = torch.arange(S, device=device)[:, None] + q_offset
    ki = torch.arange(T, device=device)[None, :] + k_offset
    return ki <= qi


def _dense_attention(q, k, v, causal: bool, q_offset=0) -> torch.Tensor:
    """Materialised scores: ``q`` (B, S, KV, G, hd), ``k``/``v`` (B, T,
    KV, hd) -> (B, S, KV·G, hd) in ``v``'s dtype."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    logits = torch.einsum("bskgh,btkh->bkgst", q.float(),
                          k.float()) * _scale(hd)
    if causal:
        logits = torch.where(_causal_mask(S, T, q_offset, 0, q.device),
                             logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype), v)
    return out.reshape(B, S, KV * G, hd)


def _chunked_attention(q, k, v, causal: bool, chunk: int,
                       q_offset=0) -> torch.Tensor:
    """Online softmax over KV blocks of ``chunk`` keys (the reference's
    ``lax.scan``); ``T`` must be a multiple of ``chunk``."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    assert T % chunk == 0, (T, chunk)
    qf = q.float() * _scale(hd)
    m = torch.full((B, KV, G, S), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, S, hd), dtype=torch.float32,
                      device=q.device)
    for j in range(T // chunk):
        kc = k[:, j * chunk:(j + 1) * chunk].float()
        vc = v[:, j * chunk:(j + 1) * chunk].float()
        logits = torch.einsum("bskgh,btkh->bkgst", qf, kc)
        if causal:
            logits = torch.where(
                _causal_mask(S, chunk, q_offset, j * chunk, q.device),
                logits, _NEG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(logits - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkh->bkgsh",
                                                    pexp, vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4)                      # (B,S,KV,G,hd)
    return out.reshape(B, S, KV * G, hd).to(v.dtype)


def _attend(cfg, qg, k, v, causal: bool, q_offset=0) -> torch.Tensor:
    """The chunked path above ``cfg.attn_chunk`` keys, else the dense."""
    if cfg.attn_chunk and k.shape[1] > cfg.attn_chunk:
        return _chunked_attention(qg, k, v, causal, cfg.attn_chunk,
                                  q_offset)
    return _dense_attention(qg, k, v, causal, q_offset)


def attention_train(params, cfg, x, positions, *, causal: bool = True,
                    xkv=None, kv_positions=None, dtype=torch.bfloat16,
                    return_kv: bool = False):
    """Full-sequence (self- or cross-) attention; ``return_kv=True`` also
    returns the (rotated) keys and the values, for the cache."""
    if xkv is None:
        xkv, kv_positions = x, positions
    q, k, v = _qkv(params, cfg, x, xkv, positions, kv_positions, dtype)
    qg, kh, vh = _heads(cfg, q, k, v)
    out = _attend(cfg, qg, kh, vh, causal)
    B, S = x.shape[:2]
    y = dense(params, "wo", out.reshape(B, S, -1), dtype)
    if return_kv:
        return y, (k, v)
    return y


# ----------------------------------------------------------------------
# Decode path
# ----------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, *,
                  device) -> dict:
    """The cache of one attention block: ``k``/``v`` ``(batch, max_len,
    KV, hd)`` in ``dtype``, or with ``cfg.kv_cache_dtype == "int8"`` int8
    codes and bfloat16 scales ``k_s``/``v_s`` ``(batch, max_len, KV,
    1)``; ``KV`` this rank's KV heads under a tensor-parallel split."""
    shape = (batch, max_len, tp.local_kv(cfg), cfg.hd)
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(sshape, dtype=torch.bfloat16,
                                   device=device),
                "v_s": torch.zeros(sshape, dtype=torch.bfloat16,
                                   device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _kv_quant(t: torch.Tensor):
    """(B, S, KV, hd) -> int8 codes and bfloat16 per-(token, head)
    scales ``max|t| / 127``; the divides are IEEE divisions by tensors,
    and rounding is half to even, as ``jnp.round``."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8)
    scale = scale / torch.full_like(scale, 127.0)
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor,
                dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def _update(buf: torch.Tensor, new: torch.Tensor, index) -> torch.Tensor:
    """A copy of ``buf`` with ``new`` written along axis 1 at ``index``,
    the start clamped so that the update fits, as
    ``jax.lax.dynamic_update_slice_in_dim`` clamps it."""
    T, n = buf.shape[1], new.shape[1]
    i = min(max(int(index), 0), T - n)
    out = buf.clone()
    out[:, i:i + n] = new.to(buf.dtype)
    return out


def sp_shards():
    """``(mesh, sp axes, shards)`` of flash-decoding under the active
    sharding context (``rules.flash_decode``, ``sp`` axes the mesh has,
    in the rules' order, of more than one rank in all), else ``None``."""
    ctx = fsdp.active()
    if ctx is None or not ctx[1].flash_decode:
        return None
    mesh, rules = ctx
    axes = tuple(a for a in rules.sp if a in mesh.mesh_dim_names)
    n = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)
    return None if n == 1 else (mesh, axes, n)


def _decode_attend_sp(cfg, qg, k_new, v_new, cache: dict, index, dtype):
    """Flash-decoding over this rank's slice of the cache (module
    docstring): ``(out (B, 1, KV, G, hd) in dtype, new cache)``, or
    ``None`` outside such a context."""
    sp = sp_shards()
    if sp is None:
        return None
    mesh, axes, _ = sp
    groups = [mesh.get_group(i) for i in fsdp.axis_dims(mesh, axes)]
    B, _, KV, G, hd = qg.shape
    T_loc = cache["k"].shape[1]
    off = fsdp.axes_offset(mesh, axes, T_loc)
    index = int(index)
    li = min(max(index - off, 0), T_loc - 1)
    mine = off <= index < off + T_loc

    def upd(buf, new):
        out = buf.clone()
        if mine:
            out[:, li:li + 1] = new.to(buf.dtype)
        return out

    if cfg.kv_cache_dtype == "int8":
        kq, ks = _kv_quant(k_new)
        vq, vs = _kv_quant(v_new)
        nc = {"k": upd(cache["k"], kq), "v": upd(cache["v"], vq),
              "k_s": upd(cache["k_s"], ks), "v_s": upd(cache["v_s"], vs)}
        k = _kv_dequant(nc["k"], nc["k_s"], dtype)
        v = _kv_dequant(nc["v"], nc["v_s"], dtype)
    else:
        nc = {"k": upd(cache["k"], k_new), "v": upd(cache["v"], v_new)}
        k, v = nc["k"], nc["v"]
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.float()) * _scale(hd)
    ki = off + torch.arange(T_loc, device=qg.device)[None, :]
    logits = torch.where(ki <= index, logits, _NEG)
    m = logits.amax(dim=-1)                               # (B, KV, G, 1)
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgst,btkh->bkgsh", p, v.float())
    for g in groups:
        dist.all_reduce(l, group=g)
        dist.all_reduce(acc, group=g)
    fsdp.COUNTS["all_reduce"] += 3 * len(groups)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(dtype), nc


def attention_decode(params, cfg, x, cache: dict, index, *,
                     dtype=torch.bfloat16):
    """One-token step: write the token's keys and values at ``index``
    and attend to the cached prefix (keys past ``index`` are masked).
    ``x``: (B, 1, d); ``index``: the position, a Python int.  Under
    flash-decoding ``cache`` is this rank's slice
    (:func:`_decode_attend_sp`)."""
    B = x.shape[0]
    positions = torch.full((B, 1), int(index), dtype=torch.int32,
                           device=x.device)
    if cfg.rope == "mrope":
        positions = positions.expand(3, B, 1)
    q, k_new, v_new = _qkv(params, cfg, x, x, positions, positions, dtype)
    if sp_shards() is not None:
        out, new_cache = _decode_attend_sp(cfg, _group(q, k_new.shape[2]),
                                           k_new, v_new, cache, index, dtype)
        return dense(params, "wo", out.reshape(B, 1, -1), dtype), new_cache
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _kv_quant(k_new)
        vq, vs = _kv_quant(v_new)
        new_cache = {"k": _update(cache["k"], kq, index),
                     "v": _update(cache["v"], vq, index),
                     "k_s": _update(cache["k_s"], ks, index),
                     "v_s": _update(cache["v_s"], vs, index)}
        k = _kv_dequant(new_cache["k"], new_cache["k_s"], dtype)
        v = _kv_dequant(new_cache["v"], new_cache["v_s"], dtype)
    else:
        k = _update(cache["k"], k_new, index)
        v = _update(cache["v"], v_new, index)
        new_cache = {"k": k, "v": v}
    qg, k, v = _heads(cfg, q, k, v)
    out = _attend(cfg, qg, k, v, True, q_offset=int(index))
    y = dense(params, "wo", out.reshape(B, 1, -1), dtype)
    return y, new_cache


def attention_cross_step(params, cfg, x, k, v, *, dtype=torch.bfloat16):
    """Decode-time cross-attention against precomputed encoder keys and
    values (dense, not causal)."""
    B = x.shape[0]
    q = dense(params, "wq", x, dtype).reshape(B, 1, -1, cfg.hd)
    out = _dense_attention(*_heads(cfg, q, k, v), causal=False)
    return dense(params, "wo", out.reshape(B, 1, -1), dtype)
