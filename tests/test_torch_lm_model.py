"""The port's language model (xlstm-125m, reduced) against the JAX
package on the CPU, on the same parameters (the reference's seeded init
carried over by ``convert.lm_params_from_reference``) and the same
numpy tokens.

float32 throughout: logits of ``forward``, ``prefill`` and
``decode_step`` and every decode-cache leaf within rtol = atol = 2e-4
(the sLSTM kernel's tolerance; the mLSTM's einsums and the exponentials
differ by ulps between the frameworks).  A bfloat16 model is held at
5e-2·max(1, max|ref|), the reference's bf16 kernel tolerance.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as ref_model
from repro_torch.configs import ARCHS
from repro_torch.convert import (lm_cache_from_reference,
                                 lm_params_from_reference)
from repro_torch.models import (decode_step, forward, init_cache,
                                init_model, prefill)

ARCH = "xlstm-125m"
TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(reference params, port model, config) from one reference init."""
    cfg = REF_ARCHS[ARCH].reduced()
    params, _ = ref_model.init_model(cfg, jax.random.PRNGKey(0))
    port = lm_params_from_reference(_np_tree(params), ARCHS[ARCH].reduced(),
                                    device="cpu")
    return params, port, ARCHS[ARCH].reduced()


def _tokens(cfg, shape=(B, S), seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _cache_close(got, want):
    want = _np_tree(want)
    assert sorted(got["blocks"]) == sorted(want["blocks"])
    for name, leaves in want["blocks"].items():
        assert sorted(got["blocks"][name]) == sorted(leaves)
        for k, v in leaves.items():
            _close(got["blocks"][name][k], v)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_configs_are_the_reference_values(arch):
    assert dataclasses.asdict(ARCHS[arch]) == \
        dataclasses.asdict(REF_ARCHS[arch])
    assert dataclasses.asdict(ARCHS[arch].reduced()) == \
        dataclasses.asdict(REF_ARCHS[arch].reduced())
    assert ARCHS[arch].param_count() == REF_ARCHS[arch].param_count()


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", [ARCH, "whisper-small", "qwen2-vl-2b",
                                  "jamba-v0.1-52b", "kimi-k2-1t-a32b"])
def test_parameters_carried_bitwise(arch):
    """Layer i holds period i // period of slot b{i % period}, encoder
    layer i entry i of enc_blocks/b0; top-level leaves (frontend,
    norm_enc_*) carried; every leaf bitwise (the Mamba mixer's, the MoE
    router's and the (E, d, ff) expert stacks included); and a tree with
    a missing leaf raises."""
    cfg = ARCHS[arch].reduced()
    params, _ = ref_model.init_model(REF_ARCHS[arch].reduced(),
                                     jax.random.PRNGKey(0))
    np_params = _np_tree(params)
    port = lm_params_from_reference(np_params, cfg, device="cpu")
    for name, t in port.named_parameters(recurse=False):
        np.testing.assert_array_equal(t.numpy(), np_params[name])
    stacks = [("blocks", port.layers, cfg.period)]
    if cfg.enc_dec:
        stacks.append(("enc_blocks", port.enc_layers, 1))
    for stack, blocks, period in stacks:
        for i, block in enumerate(blocks):
            p, j = divmod(i, period)
            for name, t in block.named_parameters():
                np.testing.assert_array_equal(
                    t.numpy(), _leaf(np_params[stack][f"b{j}"], name)[p])
    n_ref = sum(a.size for a in jax.tree.leaves(np_params))
    assert sum(t.numel() for t in port.parameters()) == n_ref
    if arch == ARCH:
        broken = dict(np_params, blocks={
            "b0": np_params["blocks"]["b0"],
            "b1": {k: v for k, v in np_params["blocks"]["b1"].items()
                   if k != "ln1_bias"}})
        missing = "ln1_bias"
    elif cfg.enc_dec:
        b0 = dict(np_params["enc_blocks"]["b0"])
        b0["mixer"] = {k: v for k, v in b0["mixer"].items() if k != "wv"}
        broken = dict(np_params, enc_blocks={"b0": b0})
        missing = "wv"
    elif cfg.moe:
        # jamba: slot b0 is a Mamba mixer; kimi-k2: slot b0 is MoE.
        sub, missing = (("mixer", "A_log") if cfg.block_pattern[0] == "mamba"
                        else ("moe", "router"))
        b0 = dict(np_params["blocks"]["b0"])
        b0[sub] = {k: v for k, v in b0[sub].items() if k != missing}
        broken = dict(np_params, blocks=dict(np_params["blocks"], b0=b0))
    else:
        broken = {k: v for k, v in np_params.items() if k != "frontend"}
        missing = "frontend"
    with pytest.raises(ValueError, match=missing):
        lm_params_from_reference(broken, cfg, device="cpu")
    if cfg.enc_dec:
        without = {k: v for k, v in np_params.items() if k != "enc_blocks"}
        with pytest.raises(ValueError, match="enc_blocks"):
            lm_params_from_reference(without, cfg, device="cpu")


@pytest.mark.parametrize("impl", ["take", "onehot"])
def test_forward_matches_reference(pair, impl):
    params, port, cfg = pair
    cfg = dataclasses.replace(cfg, gather_impl=impl)
    toks = _tokens(cfg)
    toks[0, 3] = cfg.vocab + 2      # out of range: clamped or a zero row
    got, aux = forward(port, cfg, {"tokens": toks})
    want, waux = ref_model.forward(
        params, dataclasses.replace(REF_ARCHS[ARCH].reduced(),
                                    gather_impl=impl),
        {"tokens": toks}, remat=False)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    _close(got, want)
    assert float(aux) == float(waux) == 0.0


@pytest.mark.parametrize("n", [6, 16])
def test_prefill_logits_and_cache_match_reference(pair, n):
    params, port, cfg = pair
    toks = _tokens(cfg, seed=1)[:, :n]
    got, cache = prefill(port, cfg, {"tokens": toks}, max_len=S)
    want, wcache = ref_model.prefill(params, REF_ARCHS[ARCH].reduced(),
                                     {"tokens": toks}, max_len=S)
    assert got.shape == (B, 1, cfg.vocab)
    _close(got, want)
    _cache_close(cache, wcache)


def test_prefill_chunks_match_reference(pair):
    """S = 256: the mLSTM runs two chunks of 128 with the carried state."""
    params, port, cfg = pair
    toks = _tokens(cfg, shape=(1, 256), seed=2)
    got, cache = prefill(port, cfg, {"tokens": toks}, max_len=256)
    want, wcache = ref_model.prefill(params, REF_ARCHS[ARCH].reduced(),
                                     {"tokens": toks}, max_len=256)
    _close(got, want)
    _cache_close(cache, wcache)


def test_decode_step_matches_reference(pair):
    """From the reference's own prefill cache (carried over bitwise) and
    from a fresh cache (m = -inf): logits and the new cache."""
    params, port, cfg = pair
    rcfg = REF_ARCHS[ARCH].reduced()
    toks = _tokens(cfg, seed=3)
    _, wcache = ref_model.prefill(params, rcfg, {"tokens": toks[:, :7]},
                                  max_len=S)
    fresh = ref_model.init_cache(rcfg, B, max_len=S)
    port_fresh = init_cache(cfg, B, max_len=S, device="cpu")
    _cache_close(port_fresh, fresh)
    for start, wc in ((lm_cache_from_reference(_np_tree(wcache),
                                               device="cpu"), wcache),
                      (port_fresh, fresh)):
        got, cache = decode_step(port, cfg, start, toks[:, 7:8], 7)
        want, wnew = ref_model.decode_step(params, rcfg, wc, toks[:, 7:8],
                                           jax.numpy.int32(7))
        assert got.shape == (B, 1, cfg.vocab)
        _close(got, want)
        _cache_close(cache, wnew)


def test_prefill_matches_decode(pair):
    """Prefill-then-decode equals forward on the same tokens (teacher
    force), as the reference's ``test_prefill_matches_decode``."""
    _, port, cfg = pair
    toks = _tokens(cfg, seed=4)
    full, _ = forward(port, cfg, {"tokens": toks})
    n = 6
    _, cache = prefill(port, cfg, {"tokens": toks[:, :n]}, max_len=S)
    for k in range(n, S - 1):
        lg, cache = decode_step(port, cfg, cache, toks[:, k:k + 1], k)
        _close(lg[:, 0], full[:, k].numpy())


def test_bf16_model_close_to_reference(pair):
    """The same parameters in bfloat16: embedding scale rounded in bf16 on
    both sides, matrix products and norms in the compute dtype."""
    params, _, cfg = pair
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    rcfg16 = dataclasses.replace(REF_ARCHS[ARCH].reduced(),
                                 param_dtype="bfloat16")
    params16 = jax.tree.map(lambda a: a.astype(jax.numpy.bfloat16), params)
    port16 = lm_params_from_reference(_np_tree(params16), cfg16,
                                      device="cpu")
    assert port16.embed.dtype == torch.bfloat16
    toks = _tokens(cfg, seed=5)
    got, _ = forward(port16, cfg16, {"tokens": toks})
    want, _ = ref_model.forward(params16, rcfg16, {"tokens": toks},
                                remat=False)
    want = np.asarray(want, np.float32)
    tol = 5e-2 * max(1.0, float(np.abs(want).max()))
    _close(got, want, rtol=0, atol=tol)


def test_init_model_is_seeded():
    cfg = ARCHS[ARCH].reduced()
    a, b = (init_model(cfg, seed=7, device="cpu") for _ in range(2))
    c = init_model(cfg, seed=8, device="cpu")
    for (name, x), y, z in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(x, y), name
        if name.endswith(("_scale", "_bias")):
            continue
        assert not torch.equal(x, z), name
    # Draws follow Param.add: embed at 1/sqrt(d), r_zifo at 1/sqrt(di).
    std = float(a.embed.std())
    assert abs(std * np.sqrt(cfg.d_model) - 1.0) < 0.05
    assert not any(p.requires_grad for p in a.parameters())
