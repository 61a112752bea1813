"""The port's architectures against the JAX package on the CPU:
chatglm3-6b (RoPE 2d, GQA, qkv bias; also with the int8 KV cache),
mistral-nemo-12b, internlm2-20b, nemotron-4-15b (squared ReLU),
qwen2-vl-2b (M-RoPE, a vision patch prefix), whisper-small (an
encoder-decoder with sinusoidal positions and cross-attention),
jamba-v0.1-52b (Mamba and attention, MoE on every second block; also
with ``capacity_factor=0.25``, so that assignments drop inside the
model), qwen3-moe-235b-a22b and kimi-k2-1t-a32b (MoE on every block),
each at its ``reduced()`` widths, on the same parameters (the
reference's seeded init carried over by
``convert.lm_params_from_reference``) and the same numpy inputs.

float32: logits and aux loss of ``forward``, logits of ``prefill`` and
of two ``decode_step`` s, and every decode-cache leaf, within rtol =
atol = 2e-4 (int8 codes within 1: a division may round the other way
where a value lies at a half-integer).  The same parameters in bfloat16
within 5e-2·max(1, max|ref|), per output and per leaf, against the
reference run op by op (``jax.disable_jit()``): each jnp operation then
rounds to bfloat16 as written, where XLA's compiled CPU code fuses some
bfloat16 chains and rounds them once.  That difference alone, under the
same expert choices, moves reduced jamba's Mamba states past the bound,
and it flips MoE routers whose top-k margins are that small, while the port
holds the op-by-op reference well inside it.  Then the
serving engine on chatglm3-6b.reduced() and jamba-v0.1-52b.reduced()
against the reference's engine, and mirrors of
``tests/test_serving_regressions.py`` on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as ref_model
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import ARCHS
from repro_torch.convert import (lm_cache_from_reference,
                                 lm_params_from_reference)
from repro_torch.launch import serve
from repro_torch.models import decode_step, forward, init_cache, prefill
from repro_torch.models.model import FRONTEND_DIM
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import _masked_decode_step

# (architecture, config overrides): the nine beside xlstm-125m, chatglm3
# with the int8 KV cache, and jamba with a capacity that drops.
CASES = [("chatglm3-6b", {}), ("chatglm3-6b", {"kv_cache_dtype": "int8"}),
         ("mistral-nemo-12b", {}), ("internlm2-20b", {}),
         ("nemotron-4-15b", {}), ("qwen2-vl-2b", {}), ("whisper-small", {}),
         ("jamba-v0.1-52b", {}), ("jamba-v0.1-52b", {"capacity_factor": 0.25}),
         ("qwen3-moe-235b-a22b", {}), ("kimi-k2-1t-a32b", {})]
IDS = [a + "".join(f"-{v}" for v in o.values()) for a, o in CASES]
TOL = dict(rtol=2e-4, atol=2e-4)
B, S, MAX_LEN = 2, 12, 24
N_PATCHES, N_FRAMES = 4, 16

@pytest.fixture(scope="module")
def pairs():
    """``get(arch, over, dtype)`` -> (reference config, reference params,
    port config, port model), one reference init per case."""
    made = {}

    def get(arch, over, dtype="float32"):
        key = (arch, tuple(sorted(over.items())), dtype)
        if key not in made:
            rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(),
                                       param_dtype=dtype, **over)
            cfg = dataclasses.replace(ARCHS[arch].reduced(),
                                      param_dtype=dtype, **over)
            params, _ = ref_model.init_model(rcfg, jax.random.PRNGKey(0))
            port = lm_params_from_reference(
                jax.tree.map(np.asarray, params), cfg, device="cpu")
            made[key] = rcfg, params, cfg, port
        return made[key]

    return get


def _batch(cfg, seed=0, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (B, N_PATCHES, FRONTEND_DIM["vision"])).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (B, N_FRAMES, FRONTEND_DIM["audio"])).astype(np.float32)
    return batch


def _seq(cfg, batch):
    """The positions a prompt fills: the patch prefix counts."""
    return batch["tokens"].shape[1] + (
        batch["patches"].shape[1] if "patches" in batch else 0)


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _check(got, want, dtype, what):
    want = _np(want)
    got = got.float().numpy()
    assert got.shape == want.shape, what
    if dtype == "float32":
        tol = dict(rtol=0, atol=1) if want.dtype == np.int8 else TOL
    else:
        tol = dict(rtol=0, atol=5e-2 * max(1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(got, want.astype(np.float32), err_msg=what,
                               **tol)


def _check_cache(got, want, dtype):
    assert sorted(got["blocks"]) == sorted(want["blocks"])
    for name, leaves in want["blocks"].items():
        assert sorted(got["blocks"][name]) == sorted(leaves)
        for k, v in leaves.items():
            g = got["blocks"][name][k]
            assert str(g.dtype).split(".")[-1] == np.asarray(v).dtype.name
            _check(g, v, dtype, f"{name}/{k}")


def _run_both(pair, dtype):
    """forward, prefill and two decode steps on both packages (the
    reference op by op in bfloat16); returns [(what, port output,
    reference output)] and the caches."""
    with jax.disable_jit(dtype == "bfloat16"):
        return _run_pair(pair)


def _run_pair(pair):
    rcfg, params, cfg, port = pair
    batch = _batch(cfg)
    out = []
    want, want_aux = ref_model.forward(params, rcfg, batch, remat=False)
    got, aux = forward(port, cfg, batch)
    if not cfg.moe:
        assert float(aux) == 0.0
    out.append(("forward", got, want))
    out.append(("aux", aux, want_aux))
    wl, wc = ref_model.prefill(params, rcfg, batch, max_len=MAX_LEN)
    gl, gc = prefill(port, cfg, batch, max_len=MAX_LEN)
    out.append(("prefill", gl, wl))
    caches = [("prefill cache", gc, wc)]
    n = _seq(cfg, batch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, 2)).astype(
        np.int32)
    for step in range(2):
        wl, wc = ref_model.decode_step(params, rcfg, wc,
                                       toks[:, step:step + 1],
                                       jnp.int32(n + step))
        gl, gc = decode_step(port, cfg, gc, toks[:, step:step + 1], n + step)
        out.append((f"decode {step}", gl, wl))
        caches.append((f"decode {step} cache", gc, wc))
    return out, caches


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_reference(pairs, arch, over, dtype):
    out, caches = _run_both(pairs(arch, over, dtype), dtype)
    for what, got, want in out:
        assert got.dtype == torch.float32, what
        _check(got, want, dtype, what)
    for what, got, want in caches:
        _check_cache(got, want, dtype)


def test_capacity_case_drops_assignments(pairs, monkeypatch):
    """The jamba case with capacity_factor 0.25 drops assignments in every
    MoE layer of its forward (so the case above holds the drop rule)."""
    from repro_torch.models import moe

    _, _, cfg, port = pairs("jamba-v0.1-52b", {"capacity_factor": 0.25})
    orig, drops = moe._positions_in_expert, []

    def spy(e_flat, E):
        pos = orig(e_flat, E)
        C = moe.moe_capacity(cfg, e_flat.shape[0] // cfg.top_k)
        drops.append(int((pos >= C).sum()))
        return pos

    monkeypatch.setattr(moe, "_positions_in_expert", spy)
    forward(port, cfg, _batch(cfg))
    assert len(drops) == cfg.n_layers // 2 and min(drops) > 0, drops


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_decode_from_the_reference_cache(pairs, arch, over):
    """From the reference's own prefill cache carried over bitwise (int8
    stays int8): the same logits and new cache."""
    rcfg, params, cfg, port = pairs(arch, over)
    batch = _batch(cfg, seed=2)
    _, wc = ref_model.prefill(params, rcfg, batch, max_len=MAX_LEN)
    carried = lm_cache_from_reference(jax.tree.map(np.asarray, wc),
                                      device="cpu")
    for name, leaves in wc["blocks"].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(
                carried["blocks"][name][k].float().numpy(), _np(v))
            assert str(carried["blocks"][name][k].dtype).endswith(
                np.asarray(v).dtype.name)
    n = _seq(cfg, batch)
    tok = batch["tokens"][:, :1]
    wl, wnew = ref_model.decode_step(params, rcfg, wc, tok, jnp.int32(n))
    gl, gnew = decode_step(port, cfg, carried, tok, n)
    _check(gl, wl, "float32", "decode")
    _check_cache(gnew, wnew, "float32")


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_init_cache_matches_reference(pairs, arch, over):
    rcfg, _, cfg, _ = pairs(arch, over)
    enc = N_FRAMES if cfg.enc_dec else 0
    want = ref_model.init_cache(rcfg, B, MAX_LEN, enc_len=enc)
    got = init_cache(cfg, B, MAX_LEN, enc_len=enc, device="cpu")
    _check_cache(got, want, "float32")


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mistral-nemo-12b",
                                  "internlm2-20b", "nemotron-4-15b",
                                  "whisper-small"])
def test_prefill_then_decode_equals_forward(pairs, arch):
    """Prefill then decode, teacher-forced, gives forward's logits at each
    position (the reference's ``test_prefill_matches_decode``).  Not
    qwen2-vl: after a patch prefix the reference's prefill puts text at
    M-RoPE position k + 1 and its decode at n_patches + k."""
    _, _, cfg, port = pairs(arch, {})
    batch = _batch(cfg, seed=3, s=10)
    full, _ = forward(port, cfg, batch)
    n = 6
    _, cache = prefill(port, cfg, dict(batch, tokens=batch["tokens"][:, :n]),
                       max_len=MAX_LEN)
    for k in range(n, 9):
        lg, cache = decode_step(port, cfg, cache,
                                batch["tokens"][:, k:k + 1], k)
        torch.testing.assert_close(lg[:, 0], full[:, k], **TOL)


def test_decode_index_past_the_cache_writes_the_last_row(pairs):
    """decode_step at index >= max_len writes the last row, as the
    reference's clamped dynamic_update_slice, and agrees with it."""
    rcfg, params, cfg, port = pairs("chatglm3-6b", {})
    batch = _batch(cfg, seed=4)
    _, wc = ref_model.prefill(params, rcfg, batch, max_len=S)
    _, gc = prefill(port, cfg, batch, max_len=S)
    tok = batch["tokens"][:, :1]
    for index in (S, S + 5):
        wl, wnew = ref_model.decode_step(params, rcfg, wc, tok,
                                         jnp.int32(index))
        gl, gnew = decode_step(port, cfg, gc, tok, index)
        _check(gl, wl, "float32", "logits")
        _check_cache(gnew, wnew, "float32")
        k_old, k_new = gc["blocks"]["b0"]["k"], gnew["blocks"]["b0"]["k"]
        assert torch.equal(k_new[:, :, :S - 1], k_old[:, :, :S - 1])
        assert not torch.equal(k_new[:, :, S - 1], k_old[:, :, S - 1])


def test_prefill_longer_than_the_cache_raises(pairs):
    _, _, cfg, port = pairs("chatglm3-6b", {})
    with pytest.raises(ValueError, match="max_len"):
        prefill(port, cfg, _batch(cfg), max_len=S - 1)


# ----------------------------------------------------------------------
# Serving chatglm3-6b.reduced()
# ----------------------------------------------------------------------

def _prompts(cfg, lengths=(4, 7, 5, 9)):
    rng = np.random.default_rng(0)
    # Unequal lengths: every slot in its own index group, so the masked
    # merge of the KV leaves is exercised.
    return [rng.integers(0, cfg.vocab, size=n) for n in lengths]


def _serve(engine, request_cls, prompts, **kw):
    reqs = [request_cls(rid=i, prompt=p, **kw) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done(max_ticks=200)
    return reqs


@pytest.fixture(scope="module")
def glm(pairs):
    _, params, cfg, port = pairs("chatglm3-6b", {})
    return params, port, cfg


def _engine(port, cfg, **kw):
    kw.setdefault("max_len", 64)
    return ServingEngine(cfg, port, device="cpu", **kw)


@pytest.mark.parametrize("n_slots", [2, 4])
def test_greedy_tokens_equal_the_reference_engine(glm, n_slots):
    """Four prompts of mixed lengths through continuous batching: the
    reference engine's greedy tokens, and its KV cache at the end."""
    params, port, cfg = glm
    prompts = _prompts(cfg)
    ref = RefEngine(REF_ARCHS["chatglm3-6b"].reduced(), params,
                    n_slots=n_slots, max_len=64)
    want = _serve(ref, RefRequest, prompts, max_tokens=6)
    eng = _engine(port, cfg, n_slots=n_slots)
    got = _serve(eng, Request, prompts, max_tokens=6)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done for r in got)
    _check_cache(eng.cache, ref.cache, "float32")


def test_grouped_decode_matches_single_slot_runs(glm):
    """Two slots at different positions decode exactly like solo runs."""
    _, port, cfg = glm
    prompts = _prompts(cfg)[:2]
    reqs = _serve(_engine(port, cfg, n_slots=2), Request, prompts,
                  max_tokens=5)
    for i, p in enumerate(prompts):
        solo = _serve(_engine(port, cfg, n_slots=1), Request, [p],
                      max_tokens=5)
        assert reqs[i].out_tokens == solo[0].out_tokens, i


def test_masked_merge_keeps_out_of_group_kv_rows(glm):
    """KV leaves (n_periods, B, T, KV, hd): rows outside the group are
    bit-identical to the old cache, rows inside are the full step's."""
    _, port, cfg = glm
    eng = _engine(port, cfg, n_slots=3)
    for slot, p in enumerate(_prompts(cfg)[:3]):
        _, one = prefill(port, cfg, {"tokens": torch.tensor(p)[None]}, 64)
        for name, leaves in one["blocks"].items():
            for k, v in leaves.items():
                eng.cache["blocks"][name][k][:, slot] = v[:, 0]
    old = {n: {k: v.clone() for k, v in ls.items()}
           for n, ls in eng.cache["blocks"].items()}
    tokens = torch.tensor([[3], [5], [7]])
    mask = torch.tensor([False, True, False])
    _, merged = _masked_decode_step(port, cfg, eng.cache, tokens, 7, mask)
    _, full = decode_step(port, cfg, eng.cache, tokens, 7)
    for name, leaves in merged["blocks"].items():
        for k, v in leaves.items():
            assert v.ndim == 5
            for slot in (0, 2):
                assert torch.equal(v[:, slot], old[name][k][:, slot])
            assert torch.equal(v[:, 1], full["blocks"][name][k][:, 1])
            assert not torch.equal(v[:, 1], old[name][k][:, 1]), (name, k)


def test_admit_honors_max_tokens_one(glm):
    _, port, cfg = glm
    eng = _engine(port, cfg, n_slots=2)
    (req,) = _serve(eng, Request, _prompts(cfg)[:1], max_tokens=1)
    assert req.done and len(req.out_tokens) == 1
    assert eng.slot_req == [None, None]


def test_admit_first_token_routed_through_sample(glm):
    _, port, cfg = glm
    eng = _engine(port, cfg, n_slots=1)
    calls = []
    orig = eng._sample

    def spy(logits, temps):
        calls.append(temps.clone())
        return orig(logits, temps)

    eng._sample = spy
    (req,) = _serve(eng, Request, _prompts(cfg)[:1], max_tokens=1,
                    temperature=0.7)
    assert len(calls) == 1 and float(calls[0][0]) == pytest.approx(0.7)
    assert len(req.out_tokens) == 1


def test_greedy_first_token_is_argmax(glm):
    params, port, cfg = glm
    prompt = _prompts(cfg)[0]
    logits, _ = prefill(port, cfg, {"tokens": torch.tensor(prompt)[None]},
                        max_len=64)
    expect = int(torch.argmax(logits[0, -1]))
    wlogits, _ = ref_model.prefill(params, REF_ARCHS["chatglm3-6b"].reduced(),
                                   {"tokens": prompt[None].astype(np.int32)},
                                   max_len=64)
    assert expect == int(np.argmax(np.asarray(wlogits)[0, -1]))
    (req,) = _serve(_engine(port, cfg, n_slots=1), Request, [prompt],
                    max_tokens=1)
    assert req.out_tokens == [expect]


def test_serve_launcher_on_an_attention_model(capsys):
    reqs = serve.main(["--arch", "chatglm3-6b", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-tokens",
                       "4"])
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    assert "3 reqs x 2 slots" in capsys.readouterr().out


def test_serve_launcher_on_jamba(capsys):
    """The launcher serves the hybrid Mamba/attention MoE model too."""
    reqs = serve.main(["--arch", "jamba-v0.1-52b", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-tokens",
                       "4"])
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    assert "3 reqs x 2 slots" in capsys.readouterr().out


def test_jamba_greedy_tokens_equal_the_reference_engine(pairs):
    """jamba-v0.1-52b.reduced() (Mamba states and a KV cache merged by
    slot mask, MoE in every second block) through continuous batching:
    the reference engine's greedy tokens, and its cache at the end."""
    _, params, cfg, port = pairs("jamba-v0.1-52b", {})
    prompts = _prompts(cfg)
    ref = RefEngine(REF_ARCHS["jamba-v0.1-52b"].reduced(), params,
                    n_slots=2, max_len=64)
    want = _serve(ref, RefRequest, prompts, max_tokens=6)
    eng = _engine(port, cfg, n_slots=2)
    got = _serve(eng, Request, prompts, max_tokens=6)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done for r in got)
    _check_cache(eng.cache, ref.cache, "float32")
