"""The port's attention layer (``repro_torch.models.attention``) and RoPE
(``repro_torch.models.layers``) against the JAX package on the CPU, on
the same numpy inputs drawn from a seed.

float32 at rtol = atol = 1e-5: RoPE in every variant, the M-RoPE
positions (exactly), the dense and chunked attention paths (causal and
not, with a query offset), the one-token decode with its cache update
(including an ``index`` at or past the cache's end, where
``dynamic_update_slice`` clamps the start) and the decode-time
cross-attention.  The int8 cache's codes equal the reference's but where
the reference's value lies within 1 ulp of a half-integer (there a
division that rounds the other way may move a code by one); the
bfloat16 scales are bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro_torch.configs import ARCHS
from repro_torch.models import attention, layers

TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _both(a):
    return torch.tensor(a), jnp.asarray(a)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------

@pytest.mark.parametrize("hd,theta,rd", [(16, 1e4, None), (16, 1e4, 8),
                                         (128, 1e4, 64), (64, 1e6, None)])
def test_rope_freqs(hd, theta, rd):
    _close(layers.rope_freqs(hd, theta, rd),
           ref_layers.rope_freqs(hd, theta, rd), rtol=1e-6, atol=0)


def _rope_positions(variant, B, S, seed):
    rng = np.random.default_rng(seed)
    if variant == "mrope":
        # A 2 x 3 patch grid then text: (t, h, w) differ on the patches.
        return np.asarray(ref_layers.make_positions_mrope(B, S, 6, (2, 3)))
    return rng.integers(0, 4000, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("variant", ["standard", "rope2d", "mrope", "none",
                                     "nope"])
@pytest.mark.parametrize("hd", [16, 128])
def test_apply_rope_matches_reference(variant, hd):
    B, S, H, KV = 2, 9, 4, 2
    q, k = _normal((B, S, H, hd), 1), _normal((B, S, KV, hd), 2)
    pos = _rope_positions(variant, B, S, 3)
    gq, gk = layers.apply_rope(torch.tensor(q), torch.tensor(k),
                               torch.tensor(pos), hd, 1e4, variant)
    wq, wk = ref_layers.apply_rope(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(pos), hd, 1e4, variant)
    _close(gq, wq)
    _close(gk, wk)
    if variant == "rope2d":      # the second half passes through
        assert torch.equal(gq[..., hd // 2:], torch.tensor(q)[..., hd // 2:])


@pytest.mark.parametrize("variant", ["standard", "rope2d", "mrope"])
def test_apply_rope_bf16_casts_cos_and_sin(variant):
    """In bfloat16 the reference casts cos and sin to q's dtype before it
    rotates; the port rounds at the same steps and gives the same bits."""
    B, S, H, hd = 2, 9, 2, 16
    q = _normal((B, S, H, hd), 4)
    pos = _rope_positions(variant, B, S, 5)
    qt = torch.tensor(q).to(torch.bfloat16)
    got, _ = layers.apply_rope(qt, qt, torch.tensor(pos), hd, 1e4, variant)
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    want, _ = ref_layers.apply_rope(qj, qj, jnp.asarray(pos), hd, 1e4,
                                    variant)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_mrope_needs_three_components():
    q = torch.zeros((1, 2, 1, 8))
    with pytest.raises(ValueError, match="mrope"):
        layers.apply_rope(q, q, torch.zeros((1, 2), dtype=torch.int32), 8,
                          1e4, "mrope")


@pytest.mark.parametrize("B,S,n,grid", [(2, 10, 0, None), (1, 12, 6, (2, 3)),
                                        (3, 20, 16, (4, 4)), (1, 5, 5,
                                                              (1, 5))])
def test_make_positions_mrope(B, S, n, grid):
    got = layers.make_positions_mrope(B, S, n, grid)
    want = np.asarray(ref_layers.make_positions_mrope(B, S, n, grid))
    assert got.shape == (3, B, S) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# The two attention paths
# ----------------------------------------------------------------------

def _qkv(B, S, T, KV, G, hd, seed):
    return (_normal((B, S, KV * G, hd), seed),
            _normal((B, T, KV, hd), seed + 1),
            _normal((B, T, KV, hd), seed + 2))


@pytest.mark.parametrize("causal,q_offset,S", [(True, 0, 16), (False, 0, 16),
                                               (True, 5, 1), (True, 15, 1),
                                               (False, 0, 3)])
def test_dense_attention_matches_reference(causal, q_offset, S):
    q, k, v = _qkv(2, S, 16, 2, 3, 8, 10)
    got = attention._dense_attention(
        attention._group(torch.tensor(q), 2), torch.tensor(k),
        torch.tensor(v), causal, q_offset)
    want = ref_attn._dense_attention(
        ref_attn._group(jnp.asarray(q), 2), jnp.asarray(k), jnp.asarray(v),
        causal, q_offset)
    assert got.shape == (2, S, 6, 8)
    _close(got, want)


@pytest.mark.parametrize("causal,q_offset,S,chunk", [
    (True, 0, 32, 8), (True, 0, 32, 16), (False, 0, 32, 8),
    (True, 7, 1, 8), (True, 31, 1, 4), (False, 0, 5, 16)])
def test_chunked_attention_matches_reference(causal, q_offset, S, chunk):
    q, k, v = _qkv(2, S, 32, 2, 2, 8, 20)
    got = attention._chunked_attention(
        attention._group(torch.tensor(q), 2), torch.tensor(k),
        torch.tensor(v), causal, chunk, q_offset)
    want = ref_attn._chunked_attention(
        ref_attn._group(jnp.asarray(q), 2), jnp.asarray(k), jnp.asarray(v),
        causal, chunk, q_offset)
    _close(got, want)


def test_chunked_attention_refuses_a_ragged_cache():
    q, k, v = (torch.tensor(a) for a in _qkv(1, 4, 12, 1, 2, 8, 30))
    with pytest.raises(AssertionError):
        attention._chunked_attention(attention._group(q, 1), k, v, True, 8)


def test_gqa_grouping_reads_kv_head_h_over_g():
    """Query head h reads KV head h // G: the dense path equals per-head
    attention over K/V repeated with ``repeat_interleave``."""
    B, S, KV, G, hd = 1, 6, 2, 3, 8
    q, k, v = (torch.tensor(a) for a in _qkv(B, S, S, KV, G, hd, 40))
    got = attention._dense_attention(attention._group(q, KV), k, v, True)
    kr = k.repeat_interleave(G, dim=2)
    vr = v.repeat_interleave(G, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, kr) / hd ** 0.5
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
    want = torch.einsum("bhst,bthd->bshd", p, vr)
    torch.testing.assert_close(got, want, **TOL)


# ----------------------------------------------------------------------
# The KV cache
# ----------------------------------------------------------------------

def _near_half(x: np.ndarray) -> np.ndarray:
    """Where x lies within 1 ulp of a half-integer."""
    frac = np.abs(x - np.trunc(x))
    return np.abs(frac - 0.5) <= np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quant_matches_reference(dtype):
    t = _normal((3, 17, 2, 16), 50) * 3
    t[0, 0, 0] = 0.0                       # amax clamped at 1e-8
    t[1, 2, 1, :4] = [127.0, -63.5, 0.5, 1.5]   # exact half-integer codes
    tt, tj = _both(t)
    if dtype == "bfloat16":
        tt, tj = tt.to(torch.bfloat16), tj.astype(jnp.bfloat16)
    q, s = attention._kv_quant(tt)
    wq, ws = ref_attn._kv_quant(tj)
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    assert s.shape == (3, 17, 2, 1)
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(ws.astype(jnp.float32)))
    wq = np.asarray(wq)
    diff = q.numpy().astype(np.int32) - wq
    scale = jnp.maximum(jnp.max(jnp.abs(tj.astype(jnp.float32)), -1,
                                keepdims=True), 1e-8) / 127.0
    value = np.asarray(tj.astype(jnp.float32) / scale)
    assert np.all(np.abs(diff) <= 1)
    assert np.all(_near_half(value[diff != 0]))
    _close(attention._kv_dequant(q, s, torch.float32),
           ref_attn._kv_dequant(jnp.asarray(q.numpy()), ws, jnp.float32),
           rtol=0, atol=0)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_init_kv_cache_matches_reference(kv_dtype):
    cfg = dataclasses.replace(ARCHS["mistral-nemo-12b"].reduced(),
                              kv_cache_dtype=kv_dtype)
    got = attention.init_kv_cache(cfg, 2, 16, torch.bfloat16, device="cpu")
    want = ref_attn.init_kv_cache(
        dataclasses.replace(REF_ARCHS["mistral-nemo-12b"].reduced(),
                            kv_cache_dtype=kv_dtype), 2, 16, jnp.bfloat16)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape
        assert str(got[name].dtype).split(".")[-1] == leaf.dtype.name
        assert not got[name].any()


# ----------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------

def _attn_pair(arch, **over):
    """Reference attention parameters of ``arch``'s reduced config (float32)
    and the port's copy of them."""
    rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(), **over)
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **over)
    p = ref_layers.Param(jax.random.PRNGKey(0), jnp.float32)
    ref_attn.init_attention(p, rcfg)
    params = p.params
    for name in [n for n in params if n.endswith("_b")]:
        params[name] = jnp.asarray(_normal(params[name].shape, 60))
    port = layers.Params(torch.float32, torch.device("cpu"))
    attention.init_attention(port, cfg)
    with torch.no_grad():
        for name, t in port.named_parameters():
            t.copy_(torch.tensor(np.asarray(params[name])))
    return rcfg, params, cfg, port


def _cache(rcfg, B, T, seed):
    if rcfg.kv_cache_dtype == "int8":
        k, ks = ref_attn._kv_quant(jnp.asarray(
            _normal((B, T, rcfg.n_kv_heads, rcfg.hd), seed)))
        v, vs = ref_attn._kv_quant(jnp.asarray(
            _normal((B, T, rcfg.n_kv_heads, rcfg.hd), seed + 1)))
        return {"k": k, "v": v, "k_s": ks, "v_s": vs}
    return {"k": jnp.asarray(_normal((B, T, rcfg.n_kv_heads, rcfg.hd),
                                     seed)),
            "v": jnp.asarray(_normal((B, T, rcfg.n_kv_heads, rcfg.hd),
                                     seed + 1))}


def _port_cache(cache):
    return {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16) if v.dtype == jnp.bfloat16 else
        torch.tensor(np.asarray(v)) for k, v in cache.items()}


@pytest.mark.parametrize("arch,over", [
    ("chatglm3-6b", {}), ("chatglm3-6b", {"kv_cache_dtype": "int8"}),
    ("qwen2-vl-2b", {}), ("whisper-small", {}),
    ("mistral-nemo-12b", {"attn_chunk": 8})])
@pytest.mark.parametrize("index", [0, 9, 15, 16, 20])
def test_attention_decode_matches_reference(arch, over, index):
    """The new token's keys and values land where the reference's do, also
    at ``index`` >= T (the clamp writes the last row); output and every
    cache leaf within 1e-5 (int8 codes and scales exactly)."""
    rcfg, params, cfg, port = _attn_pair(arch, **over)
    B, T = 2, 16
    x = _normal((B, 1, cfg.d_model), 70)
    cache = _cache(rcfg, B, T, 71)
    want, wc = ref_attn.attention_decode(params, rcfg, jnp.asarray(x), cache,
                                         jnp.int32(index), dtype=jnp.float32)
    got, gc = attention.attention_decode(port, cfg, torch.tensor(x),
                                         _port_cache(cache), index,
                                         dtype=torch.float32)
    _close(got, want)
    assert sorted(gc) == sorted(wc)
    for name, leaf in wc.items():
        if leaf.dtype in (jnp.int8, jnp.bfloat16):
            np.testing.assert_array_equal(
                gc[name].float().numpy(),
                np.asarray(leaf.astype(jnp.float32)))
        else:
            _close(gc[name], leaf)
    # Only the written row changed, at min(index, T - 1).
    row = min(index, T - 1)
    old = _port_cache(cache)
    changed = [t for t in range(T)
               if not torch.equal(gc["k"][:, t], old["k"][:, t])]
    assert changed == [row]


@pytest.mark.parametrize("arch", ["whisper-small", "chatglm3-6b"])
def test_attention_train_and_cross_step_match_reference(arch):
    """Self-attention over a sequence with its keys returned, and
    cross-attention (not causal) against encoder keys, at full sequence and
    at one decode token."""
    rcfg, params, cfg, port = _attn_pair(arch)
    B, S, T = 2, 6, 10
    x, enc = _normal((B, S, cfg.d_model), 80), _normal((B, T, cfg.d_model), 81)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want, (wk, wv) = ref_attn.attention_train(
        params, rcfg, jnp.asarray(x), jnp.asarray(pos), dtype=jnp.float32,
        return_kv=True)
    got, (gk, gv) = attention.attention_train(
        port, cfg, torch.tensor(x), torch.tensor(pos), dtype=torch.float32,
        return_kv=True)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w)
    want = ref_attn.attention_train(params, rcfg, jnp.asarray(x),
                                    jnp.asarray(pos), causal=False,
                                    xkv=jnp.asarray(enc), dtype=jnp.float32)
    got = attention.attention_train(port, cfg, torch.tensor(x),
                                    torch.tensor(pos), causal=False,
                                    xkv=torch.tensor(enc),
                                    dtype=torch.float32)
    _close(got, want)
    want = ref_attn.attention_cross_step(params, rcfg, jnp.asarray(x[:, :1]),
                                         wk, wv, dtype=jnp.float32)
    got = attention.attention_cross_step(port, cfg, torch.tensor(x[:, :1]),
                                         gk, gv, dtype=torch.float32)
    _close(got, want)
