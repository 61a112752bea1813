"""Residual blocks, counterpart of ``repro/models/blocks.py``: a
pre-normed mixer (``attn``, ``mamba``, ``mlstm`` or ``slstm``), a
cross-attention sub-block in the decoder of an encoder-decoder, and a
pre-normed FFN, each with a residual: the MoE layer where ``use_moe``,
else the MLP (``d_ff > 0``).  Three entry points, as the reference's:

* :func:`block_forward` — full sequence; returns (x, MoE aux loss)
* :func:`block_prefill` — full sequence, also returns the decode cache
  (an attention block's KV cache padded to ``max_len``, in the compute
  dtype or int8; a recurrent block's state): (x, cache, aux loss)
* :func:`block_step`    — one token with cache, at position ``index``

Without MoE the aux loss is ``None`` (the reference's is a zero; the
model sums only the MoE layers', and a decode step makes none).

Under a tensor-parallel split (:mod:`repro_torch.dist.tp`) each
sub-layer's input enters through :func:`tp.enter` and its output
leaves through :func:`tp.leave`: the mixers, the cross-attention and
the MLP are split (their outputs are partial sums), the MoE layer and,
under flash-decoding, the attention are whole, and so is a sub-layer
whose widths the split does not divide (:func:`tp.sub_split`).  Under
``sp_act`` the full-sequence paths take and return the stream as this
rank's block of the sequence (``seq``, which the model decides for the
call); a decode step's stream is whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import tp
from .attention import (_kv_quant, attention_cross_step, attention_decode,
                        attention_train, init_attention, init_kv_cache)
from .layers import Params, activation, apply_norm, dense, init_dense, \
    init_norm
from .moe import init_moe, moe_forward
from .ssm import (init_mamba, init_mamba_cache, init_mlstm,
                  init_mlstm_cache, init_slstm, init_slstm_cache,
                  mamba_forward, mamba_step, mlstm_forward, mlstm_step,
                  slstm_forward, slstm_step)

__all__ = ["init_mlp", "mlp_forward", "init_block", "init_block_cache",
           "block_forward", "block_prefill", "block_step"]

# Each mixer kind: (init, init_cache, forward, step).
_MIXERS = {
    "mamba": (init_mamba, init_mamba_cache, mamba_forward, mamba_step),
    "mlstm": (init_mlstm, init_mlstm_cache, mlstm_forward, mlstm_step),
    "slstm": (init_slstm, init_slstm_cache, slstm_forward, slstm_step),
}


def _check(kind: str):
    if kind != "attn" and kind not in _MIXERS:
        raise ValueError(f"unknown mixer kind {kind!r}")


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------

def init_mlp(p: Params, cfg):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "swiglu":
        init_dense(p, "w_gate", d, ff, ("fsdp", "tp"))
        init_dense(p, "w_up", d, ff, ("fsdp", "tp"))
    else:
        init_dense(p, "w_in", d, ff, ("fsdp", "tp"))
    init_dense(p, "w_down", ff, d, ("tp", "fsdp"))


def mlp_forward(params, cfg, x, dtype) -> torch.Tensor:
    if cfg.mlp_act == "swiglu":
        h = activation("swiglu")(dense(params, "w_gate", x, dtype)) \
            * dense(params, "w_up", x, dtype)
    else:
        h = activation(cfg.mlp_act)(dense(params, "w_in", x, dtype))
    return dense(params, "w_down", h, dtype)


def _split_sub(cfg, s, kind: str) -> bool:
    """Whether a sub-layer of ``kind`` is split under ``s``
    (:func:`repro_torch.dist.tp.sub_split`; the MoE layer never is)."""
    return tp.sub_split(cfg, kind, s) is not None


def _ffn_part(params, cfg, x, use_moe: bool, moe_impl: str, dtype,
              s=None, seq: bool = False):
    """The FFN sub-block: (x, MoE aux loss or None)."""
    aux = None
    if use_moe:
        h = tp.enter(apply_norm(params, "ln2", x, cfg.norm), s, False, seq)
        y, aux = moe_forward(params["moe"], cfg, h, impl=moe_impl,
                             dtype=dtype)
        x = x + tp.leave(y, s, False, seq)
    elif cfg.d_ff:
        sub = _split_sub(cfg, s, "mlp")
        h = tp.enter(apply_norm(params, "ln2", x, cfg.norm), s, sub, seq)
        x = x + tp.leave(mlp_forward(params["mlp"], cfg, h, dtype), s,
                         sub, seq)
    return x, aux


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------

def init_block(p: Params, cfg, kind: str, use_moe: bool,
               cross: bool = False):
    _check(kind)
    init_norm(p, "ln1", cfg.d_model, cfg.norm)
    mixer = p.sub("mixer")
    if kind == "attn":
        init_attention(mixer, cfg)
    else:
        _MIXERS[kind][0](mixer, cfg)
    if cross:
        init_norm(p, "lnx", cfg.d_model, cfg.norm)
        init_attention(p.sub("cross"), cfg, cross=True)
    if use_moe:
        init_norm(p, "ln2", cfg.d_model, cfg.norm)
        init_moe(p.sub("moe"), cfg)
    elif cfg.d_ff:
        init_norm(p, "ln2", cfg.d_model, cfg.norm)
        init_mlp(p.sub("mlp"), cfg)


def init_block_cache(cfg, kind: str, batch: int, max_len: int,
                     cross: bool = False, enc_len: int = 0,
                     dtype=torch.bfloat16, *, device) -> dict:
    """The decode cache of one block: an attention block's KV cache of
    ``max_len`` positions, or a recurrent state (no time axis); the
    decoder of an encoder-decoder adds ``cross_k``/``cross_v`` of
    ``enc_len`` positions."""
    _check(kind)
    if kind == "attn":
        cache = init_kv_cache(cfg, batch, max_len, dtype, device=device)
    else:
        cache = _MIXERS[kind][1](cfg, batch, device=device)
    if cross:
        shape = (batch, enc_len, tp.local_kv(cfg), cfg.hd)
        cache["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


# ----------------------------------------------------------------------
# Forward paths
# ----------------------------------------------------------------------

def _cross(params, cfg, x, positions, enc_out, enc_positions, dtype,
           s=None, seq: bool = False):
    """The cross-attention sub-block's output into the stream, and the
    (rank's) encoder keys and values."""
    sub = _split_sub(cfg, s, "cross")
    h = tp.enter(apply_norm(params, "lnx", x, cfg.norm), s, sub, seq)
    y, kv = attention_train(params["cross"], cfg, h, positions,
                            causal=False,
                            xkv=tp.enter(enc_out, s, sub, seq),
                            kv_positions=enc_positions, dtype=dtype,
                            return_kv=True)
    return tp.leave(y, s, sub, seq), kv


def _mixer_in(params, cfg, kind: str, x, s, seq: bool):
    """The mixer's input, and whether it is split."""
    sub = _split_sub(cfg, s, kind)
    return tp.enter(apply_norm(params, "ln1", x, cfg.norm), s, sub,
                    seq), sub


def block_forward(params, cfg, kind: str, use_moe: bool, x, positions=None,
                  *, causal: bool = True, cross: bool = False, enc_out=None,
                  enc_positions=None, moe_impl: str = "scatter",
                  dtype=torch.bfloat16, seq: bool = False):
    """Full sequence: (x, aux loss); ``seq``: the stream is this rank's
    block of the sequence (the model decides it for the call)."""
    _check(kind)
    s = tp.split()
    seq = seq and s is not None
    h, sub = _mixer_in(params, cfg, kind, x, s, seq)
    m = params["mixer"]
    if kind == "attn":
        mix = attention_train(m, cfg, h, positions, causal=causal,
                              dtype=dtype)
    else:
        mix = _MIXERS[kind][2](m, cfg, h, dtype=dtype)
    x = x + tp.leave(mix, s, sub, seq)
    if cross:
        x = x + _cross(params, cfg, x, positions, enc_out, enc_positions,
                       dtype, s, seq)[0]
    return _ffn_part(params, cfg, x, use_moe, moe_impl, dtype, s, seq)


def block_prefill(params, cfg, kind: str, use_moe: bool, x, positions=None,
                  max_len: int = 0, *, cross: bool = False, enc_out=None,
                  enc_positions=None, moe_impl: str = "scatter",
                  dtype=torch.bfloat16, seq: bool = False):
    """Forward and the decode cache (the sequence fills ``[0, S)`` of an
    attention block's ``max_len`` positions; the rest are zeros): (x,
    cache, aux loss); ``seq`` as in :func:`block_forward`."""
    _check(kind)
    s = tp.split()
    seq = seq and s is not None
    h, sub = _mixer_in(params, cfg, kind, x, s, seq)
    S = h.shape[1]
    if kind == "attn" and max_len < S:
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"max_len={max_len}")
    m = params["mixer"]
    if kind == "attn":
        mix, (k, v) = attention_train(m, cfg, h, positions, causal=True,
                                      dtype=dtype, return_kv=True)
        pad = (0, 0, 0, 0, 0, max_len - S)
        if cfg.kv_cache_dtype == "int8":
            kq, ks = _kv_quant(k)
            vq, vs = _kv_quant(v)
            cache = {"k": F.pad(kq, pad), "v": F.pad(vq, pad),
                     "k_s": F.pad(ks, pad), "v_s": F.pad(vs, pad)}
        else:
            cache = {"k": F.pad(k, pad).to(dtype),
                     "v": F.pad(v, pad).to(dtype)}
    else:
        mix, cache = _MIXERS[kind][2](m, cfg, h, dtype=dtype,
                                      return_state=True)
    x = x + tp.leave(mix, s, sub, seq)
    if cross:
        y, (ck, cv) = _cross(params, cfg, x, positions, enc_out,
                             enc_positions, dtype, s, seq)
        x = x + y
        cache = dict(cache, cross_k=ck.to(dtype), cross_v=cv.to(dtype))
    x, aux = _ffn_part(params, cfg, x, use_moe, moe_impl, dtype, s, seq)
    return x, cache, aux


def block_step(params, cfg, kind: str, use_moe: bool, x, cache: dict,
               index=0, *, cross: bool = False, moe_impl: str = "scatter",
               dtype=torch.bfloat16):
    """One-token decode step.  ``x``: (B, 1, d); ``index``, the position,
    is the attention kind's (the recurrent kinds carry it in their
    state).  Returns (x, new cache)."""
    _check(kind)
    s = tp.split()
    h, sub = _mixer_in(params, cfg, kind, x, s, False)
    m = params["mixer"]
    mix_cache = {k: v for k, v in cache.items()
                 if not k.startswith("cross_")}
    if kind == "attn":
        mix, new_cache = attention_decode(m, cfg, h, mix_cache, index,
                                          dtype=dtype)
    else:
        mix, new_cache = _MIXERS[kind][3](m, cfg, h, mix_cache, dtype=dtype)
    x = x + tp.leave(mix, s, sub, False)
    if cross:
        sub = _split_sub(cfg, s, "cross")
        h = tp.enter(apply_norm(params, "lnx", x, cfg.norm), s, sub, False)
        x = x + tp.leave(attention_cross_step(
            params["cross"], cfg, h, cache["cross_k"], cache["cross_v"],
            dtype=dtype), s, sub, False)
        new_cache = dict(new_cache, cross_k=cache["cross_k"],
                         cross_v=cache["cross_v"])
    x, _ = _ffn_part(params, cfg, x, use_moe, moe_impl, dtype, s)
    return x, new_cache
