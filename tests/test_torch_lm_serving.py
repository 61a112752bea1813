"""The port's ServingEngine against the reference's, on the CPU, on the
same parameters (xlstm-125m reduced, float32, the reference's seeded
init carried over) and the same numpy prompts; and mirrors of the
reference's ``tests/test_serving_regressions.py``.

The two engines sample from different generators (``jax.random`` and a
seeded :class:`torch.Generator`), so served tokens are held equal for
greedy requests only; temperature requests are held to determinism under
a seed and to legal tokens.  Cache leaves after serving: rtol = atol =
2e-4 (the sLSTM kernel's tolerance).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as ref_model
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.models import decode_step, prefill
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import _masked_decode_step

ARCH = "xlstm-125m"


@pytest.fixture(scope="module")
def pair():
    cfg = REF_ARCHS[ARCH].reduced()
    params, _ = ref_model.init_model(cfg, jax.random.PRNGKey(0))
    port = lm_params_from_reference(jax.tree.map(np.asarray, params),
                                    ARCHS[ARCH].reduced(), device="cpu")
    return params, port, ARCHS[ARCH].reduced()


def _prompts(cfg, lengths=(4, 7, 5, 9)):
    rng = np.random.default_rng(0)
    # Unequal lengths on purpose: equal ones put every slot in one index
    # group and never exercise the masked merge.
    return [rng.integers(0, cfg.vocab, size=n) for n in lengths]


def _serve(engine, request_cls, prompts, **kw):
    reqs = [request_cls(rid=i, prompt=p, **kw) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done(max_ticks=200)
    return reqs


def _engine(port, cfg, **kw):
    kw.setdefault("max_len", 64)
    return ServingEngine(cfg, port, device="cpu", **kw)


def test_greedy_tokens_equal_the_reference(pair):
    """Two slots, four prompts of unequal length (continuous batching,
    grouped and masked decode): the same greedy tokens, and the same
    decode cache at the end."""
    params, port, cfg = pair
    prompts = _prompts(cfg)
    ref = RefEngine(REF_ARCHS[ARCH].reduced(), params, n_slots=2, max_len=64)
    want = _serve(ref, RefRequest, prompts, max_tokens=6)
    eng = _engine(port, cfg, n_slots=2)
    got = _serve(eng, Request, prompts, max_tokens=6)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done for r in got)
    for name, leaves in ref.cache["blocks"].items():
        for k, v in leaves.items():
            np.testing.assert_allclose(eng.cache["blocks"][name][k].numpy(),
                                       np.asarray(v), rtol=2e-4, atol=2e-4)


def test_grouped_decode_matches_single_slot_runs(pair):
    """Two slots at different positions decode exactly like solo runs."""
    _, port, cfg = pair
    prompts = _prompts(cfg)[:2]
    reqs = _serve(_engine(port, cfg, n_slots=2), Request, prompts,
                  max_tokens=5)
    for i, p in enumerate(prompts):
        solo = _serve(_engine(port, cfg, n_slots=1), Request, [p],
                      max_tokens=5)
        assert reqs[i].out_tokens == solo[0].out_tokens, i


def test_masked_merge_keeps_out_of_group_rows(pair):
    """Rows outside the group are bit-identical to the old cache; rows
    inside are the full step's."""
    _, port, cfg = pair
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
    _, merged = _masked_decode_step(port, cfg, eng.cache, tokens, 4, mask)
    _, full = decode_step(port, cfg, eng.cache, tokens, 4)
    for name, leaves in merged["blocks"].items():
        for k, v in leaves.items():
            for slot in (0, 2):
                assert torch.equal(v[:, slot], old[name][k][:, slot])
            assert torch.equal(v[:, 1], full["blocks"][name][k][:, 1])
            assert not torch.equal(v[:, 1], old[name][k][:, 1]), (name, k)


def test_admit_honors_max_tokens_one(pair):
    """A max_tokens=1 request retires at admit with exactly one token,
    never occupying a slot."""
    _, port, cfg = pair
    eng = _engine(port, cfg, n_slots=2)
    (req,) = _serve(eng, Request, _prompts(cfg)[:1], max_tokens=1)
    assert req.done and len(req.out_tokens) == 1
    assert eng.slot_req == [None, None]


def test_admit_first_token_routed_through_sample(pair):
    _, port, cfg = pair
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


def test_greedy_first_token_is_argmax(pair):
    params, port, cfg = pair
    prompt = _prompts(cfg)[0]
    logits, _ = prefill(port, cfg, {"tokens": torch.tensor(prompt)[None]},
                        max_len=64)
    expect = int(torch.argmax(logits[0, -1]))
    wlogits, _ = ref_model.prefill(params, REF_ARCHS[ARCH].reduced(),
                                   {"tokens": prompt[None].astype(np.int32)},
                                   max_len=64)
    assert expect == int(np.argmax(np.asarray(wlogits)[0, -1]))
    (req,) = _serve(_engine(port, cfg, n_slots=1), Request, [prompt],
                    max_tokens=1)
    assert req.out_tokens == [expect]


def test_temperature_sampling_is_seeded_and_legal(pair):
    _, port, cfg = pair
    runs = [[r.out_tokens for r in _serve(
        _engine(port, cfg, n_slots=2, seed=seed), Request, _prompts(cfg),
        max_tokens=8, temperature=0.8)] for seed in (3, 3, 4)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert all(0 <= t < cfg.vocab for run in runs for toks in run
               for t in toks)


def test_max_len_retires_a_request(pair):
    """A slot whose position reaches max_len - 1 retires early, as in the
    reference."""
    params, port, cfg = pair
    prompts = [_prompts(cfg)[3]]                      # 9 tokens
    want = _serve(RefEngine(REF_ARCHS[ARCH].reduced(), params, n_slots=1,
                            max_len=12), RefRequest, prompts, max_tokens=20)
    got = _serve(_engine(port, cfg, n_slots=1, max_len=12), Request,
                 prompts, max_tokens=20)
    assert len(got[0].out_tokens) == len(want[0].out_tokens) == 3
    assert got[0].out_tokens == want[0].out_tokens


def test_eos_retires_a_request(pair):
    _, port, cfg = pair
    (first,) = _serve(_engine(port, cfg, n_slots=1), Request,
                      _prompts(cfg)[:1], max_tokens=6)
    eos = first.out_tokens[2]
    (req,) = _serve(_engine(port, cfg, n_slots=1, eos_id=eos), Request,
                    _prompts(cfg)[:1], max_tokens=6)
    assert req.out_tokens == first.out_tokens[:first.out_tokens.index(eos)
                                              + 1]


def test_engine_refuses_a_model_on_another_device(pair):
    _, port, cfg = pair
    with pytest.raises(ValueError, match="lies on"):
        ServingEngine(cfg, port, device="meta")


def test_serve_launcher_on_the_cpu(capsys):
    reqs = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                       "--max-tokens", "4"])
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    assert "3 reqs x 2 slots" in capsys.readouterr().out


def test_serve_launchers_have_the_same_defaults(monkeypatch):
    """The reference's ``main()`` reads ``sys.argv``; both parsers are
    caught at ``parse_args`` and their defaults compared."""
    import argparse

    from repro.launch import serve as ref_serve

    class Parsed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        raise Parsed({a.dest: a.default for a in self._actions
                      if a.dest != "help"})

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    monkeypatch.setattr("sys.argv", ["serve"])
    found = []
    for main in (ref_serve.main, serve.main):
        with pytest.raises(Parsed) as exc:
            main()
        found.append(exc.value.args[0])
    ref, port = found
    assert port.pop("device") == "cuda"
    assert port == ref and port["arch"] == "chatglm3-6b"
