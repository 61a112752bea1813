"""The reference's divisibility guard under a mesh, against the JAX
package on the CPU.

Where a split does not divide a shape, the reference's ``valid_spec``
(``repro/dist/sharding.py``) replicates that dimension and GSPMD
computes it whole; its flash-decoding falls back to the plain decode
(``repro/models/attention.py``).  The port computes that part whole on
every rank.  Each case runs a reduced config in float32 on two gloo
ranks, from the port's seeded parameters placed on the mesh (the
reference runs on the same values, carried over by
``convert.lm_tree_to_reference``):

- ``vocab255``: a vocabulary of 255 at tp = 2 (the one-device embedding,
  logits and cross-entropy on every rank);
- ``dff127``: an FFN of 127 at tp = 2 (the MLP whole);
- ``mlstm1``: xlstm-125m with one mLSTM head at tp = 2 (the mLSTM whole,
  the sLSTM split);
- ``gqa63``: 6 query heads over 3 KV heads at tp = 2 (rank 0's heads 0-2
  read KV heads 0, 0, 1; rank 1's 3-5 read 1, 2, 2);
- ``batch3``: a batch of 3 rows on ``data`` = 2 (replicated);
- ``oddsp``: an 11-token prompt under ``tp = sp_act`` (the stream whole);
- ``flash9``: ``max_len`` 9 under flash-decoding on (1, 2) (the plain
  decode, every position on each rank);
- ``einsum`` and ``grouped``: qwen3-moe reduced on ``data`` = 2 with those
  MoE dispatches (every rank's rows gathered, the one-device dispatch).

For each: the forward's logits and aux loss, the prefill's logits and two
decode steps against ``repro.models.model`` on one device, within rtol =
atol = 2e-4; one training step's loss, gradient norm and every gradient
leaf (put back together) against the port's own step on one device,
within the same bound.  About 15 s in one worker: the ranks run while
the reference compiles, each of its calls jitted whole.
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as ref_model
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_tree_to_reference
from repro_torch.models.model import WHOLE_POSITIONS, init_model

from _torch_ranks import run_ranks

TOL = dict(rtol=2e-4, atol=2e-4)
TP = {"mesh": [1, 2], "rules": {"batch": ["data"], "fsdp": ["data"],
                                "tp": ["model"]}}
DATA = {"mesh": [2, 1], "rules": {"batch": ["data"], "fsdp": ["data"],
                                  "tp": ["model"]}}
# case: (arch, config overrides, mesh and rules, B, S, max_len, moe_impl)
CASES = {
    "vocab255": ("chatglm3-6b", {"vocab": 255}, TP, 2, 12, 16, "scatter"),
    "dff127": ("chatglm3-6b", {"d_ff": 127}, TP, 2, 12, 16, "scatter"),
    "mlstm1": ("xlstm-125m", {"n_heads": 1}, TP, 2, 12, 16, "scatter"),
    "gqa63": ("chatglm3-6b", {"n_heads": 6, "n_kv_heads": 3}, TP, 2, 12,
              16, "scatter"),
    "batch3": ("chatglm3-6b", {}, DATA, 3, 12, 16, "scatter"),
    "oddsp": ("chatglm3-6b", {}, {"mesh": [1, 2], "rules": {
        "batch": ["data"], "fsdp": [], "tp": ["model"],
        "sp_act": ["model"]}}, 2, 11, 16, "scatter"),
    "flash9": ("chatglm3-6b", {}, {"mesh": [1, 2], "rules": {
        "batch": ["data"], "fsdp": [], "tp": ["model"], "sp": ["model"],
        "flash_decode": True}}, 2, 5, 9, "scatter"),
    "einsum": ("qwen3-moe-235b-a22b", {}, DATA, 2, 12, 16, "einsum"),
    "grouped": ("qwen3-moe-235b-a22b", {}, DATA, 2, 12, 16, "grouped"),
}

_RANKS = """
import dataclasses
import numpy as np
from repro_torch.configs import ARCHS
from repro_torch.dist import fsdp, place_params
from repro_torch.dist.sharding import ShardingRules, sharding_context
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M
from repro_torch.training.optim import global_norm

D = os.environ["CASE_DIR"]
spec = json.load(open(f"{D}/cases.json"))


def step(model, cfg, batch, impl):
    loss, _ = M.loss_fn(model, cfg, batch, moe_impl=impl, remat=False)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()),
                                                allow_unused=True)))
    norm = float(global_norm({k: g for k, g in grads.items()
                              if g is not None}))
    full = {k: fsdp.full_value(g).numpy() for k, g in grads.items()
            if g is not None}
    return float(loss.detach()), norm, full


def run_case(case, c, meshes):
    cfg = dataclasses.replace(ARCHS[c["arch"]].reduced(), **c["over"])
    rules = ShardingRules(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in c["rules"].items()})
    mesh = meshes[tuple(c["mesh"])]
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(f"{D}/{case}_batch.npz").items()}
    toks = np.load(f"{D}/{case}_steps.npy")
    impl = c["impl"]
    out = {}
    model = M.init_model(cfg, seed=0, device="cpu")
    with torch.no_grad(), sharding_context(mesh, rules):
        place_params(model, M.param_specs(cfg), mesh, rules)
        lg, aux = M.forward(model, cfg, batch, moe_impl=impl, remat=False)
        out["forward"], out["aux"] = lg.numpy(), aux.numpy()
        pl, cache = M.prefill(model, cfg, batch, c["max_len"],
                              moe_impl=impl)
        out["prefill"] = pl.numpy()
        for i in range(toks.shape[1]):
            lg, cache = M.decode_step(model, cfg, cache, toks[:, i:i + 1],
                                      c["n"] + i, moe_impl=impl)
            out[f"decode{i}"] = lg.numpy()
    out["cache_k"] = list(cache["blocks"]["b0"].get(
        "k", cache["blocks"]["b0"].get("C")).shape)
    out["whole_positions"] = M.WHOLE_POSITIONS in cache
    model.requires_grad_(True)
    with sharding_context(mesh, rules):
        loss, norm, grads = step(model, cfg, batch, impl)
    if RANK == 0:               # every rank holds the same gathered values
        one = M.init_model(cfg, seed=0, device="cpu").requires_grad_(True)
        loss1, norm1, grads1 = step(one, cfg, batch, impl)
        out["loss"], out["grad_norm"] = loss, norm
        out["loss_one"], out["grad_norm_one"] = loss1, norm1
        err = {k: float(np.abs(grads[k] - grads1[k]).max()
                        / max(1.0, np.abs(grads1[k]).max())) for k in grads1}
        out["grad_leaf_err"] = max(err.values())
        out["grad_leaves"] = sorted(grads) == sorted(grads1)
    np.savez(f"{D}/{case}_r{RANK}.npz",
             **{k: v for k, v in out.items() if isinstance(v, np.ndarray)})
    return {k: v for k, v in out.items() if not isinstance(v, np.ndarray)}


def main():
    meshes = {(1, 2): make_local_mesh(1, 2, device="cpu"),
              (2, 1): make_local_mesh(2, 1, device="cpu")}
    return {case: run_case(case, c, meshes)
            for case, c in spec["cases"].items()}
"""


def _inputs(d, case):
    """The reference's config, the port's parameters (seed 0) in the
    reference's layout and the inputs of ``case``, written for the
    ranks; returns them and the ranks' spec."""
    arch, over, layout, B, S, max_len, impl = CASES[case]
    cfg = dataclasses.replace(REF_ARCHS[arch].reduced(), **over)
    pcfg = dataclasses.replace(ARCHS[arch].reduced(), **over)
    params = lm_tree_to_reference(dict(init_model(
        pcfg, seed=0, device="cpu").named_parameters()), pcfg)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    steps = rng.integers(0, cfg.vocab, (B, 2)).astype(np.int32)
    np.savez(d / f"{case}_batch.npz", **batch)
    np.save(d / f"{case}_steps.npy", steps)
    spec = {"arch": arch, "over": over, "mesh": layout["mesh"],
            "rules": layout["rules"], "max_len": max_len, "n": S,
            "impl": impl}
    return (cfg, params, batch, steps), spec


def _reference(case, cfg, params, batch, steps):
    """The reference's forward, prefill and two decode steps, each
    jitted whole (one compilation, not one per operation)."""
    _, _, _, _, S, max_len, impl = CASES[case]
    tokens = {"tokens": batch["tokens"]}
    forward = jax.jit(lambda p, b: ref_model.forward(
        p, cfg, b, moe_impl=impl, remat=False))
    prefill = jax.jit(lambda p, b: ref_model.prefill(
        p, cfg, b, max_len, moe_impl=impl))
    decode = jax.jit(lambda p, c, t, i: ref_model.decode_step(
        p, cfg, c, t, i, moe_impl=impl))
    want = {}
    want["forward"], want["aux"] = forward(params, tokens)
    want["prefill"], cache = prefill(params, tokens)
    for i in range(2):
        want[f"decode{i}"], cache = decode(params, cache, steps[:, i:i + 1],
                                           jnp.int32(S + i))
    return {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks run in a thread while the reference compiles here."""
    d = tmp_path_factory.mktemp("replicate")
    inputs, spec = {}, {}
    for case in CASES:
        inputs[case], spec[case] = _inputs(d, case)
    (d / "cases.json").write_text(json.dumps({"cases": spec}))
    done = {}

    def ranks():
        try:
            done["got"] = run_ranks(_RANKS, 2, d, env={"CASE_DIR": str(d)},
                                    timeout=400)
        except BaseException as e:          # re-raised below
            done["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        want = {case: _reference(case, *inputs[case]) for case in CASES}
    finally:
        thread.join()
    if "error" in done:
        raise done["error"]
    ranks_out = {case: [dict(np.load(d / f"{case}_r{r}.npz"))
                        for r in range(2)] for case in CASES}
    return want, ranks_out, done["got"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_guarded_split_matches_the_reference(runs, case):
    want, ranks, got = runs
    for r, out in enumerate(ranks[case]):
        for what in ("forward", "aux", "prefill", "decode0", "decode1"):
            np.testing.assert_allclose(out[what], want[case][what],
                                       err_msg=f"{case} rank {r} {what}",
                                       **TOL)
    g = got[case]
    np.testing.assert_allclose(g["loss"], g["loss_one"], **TOL)
    np.testing.assert_allclose(g["grad_norm"], g["grad_norm_one"], **TOL)
    assert g["grad_leaves"] and g["grad_leaf_err"] <= 2e-4, g


def test_what_runs_whole_keeps_its_full_width(runs):
    """A replicated batch keeps all 3 rows in the cache; flash-decoding's
    fallback keeps all 9 positions and says so; the GQA straddle keeps
    the 2 KV heads each rank's query heads read; the mLSTM's one head
    stays whole."""
    _, _, got = runs
    assert got["batch3"]["cache_k"][1] == 3
    assert got["flash9"]["cache_k"][2] == 9
    assert got["flash9"]["whole_positions"] is True
    assert not any(got[c]["whole_positions"] for c in CASES if c != "flash9")
    assert got["gqa63"]["cache_k"][3] == 2
    assert got["mlstm1"]["cache_k"][2] == 1
    assert WHOLE_POSITIONS == "whole_positions"
