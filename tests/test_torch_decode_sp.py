"""Flash-decoding over a sequence-parallel KV cache against the JAX
package's plain decode, on the CPU.

chatglm3-6b reduced (vocab 128, float32) on a (2, 2) mesh of four gloo
ranks with ``tests/test_decode_sp.py``'s rules (``batch`` on ``data``,
``sp`` on ``model``, ``flash_decode``): a 14-token prefill under the
context keeps each rank's block of the cache (1 of 2 rows, 16 of 32
positions), then 4 decode steps at positions 14..17 cross from the
first sequence shard into the second.  The logits of every step, put
back together from the ranks, against the reference's ``prefill`` and
``decode_step`` without a mesh: the float32 cache ("bf16" in the
reference's test, where the cache takes the compute dtype) within
1e-5·max(1, max|ref|) (1.3e-6 measured, max|ref| 3.0), the int8 cache
within the reference's 2e-2·max(1, max|ref|) (1.2e-4 measured).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as ref_model

from _torch_ranks import run_ranks

B, T, PROMPT, STEPS = 2, 32, 14, 4
KV = ("bf16", "int8")
TOL = {"bf16": 1e-5, "int8": 2e-2}

_RANKS = """
import dataclasses
import numpy as np
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_reference
from repro_torch.dist import fsdp
from repro_torch.dist.sharding import ShardingRules, sharding_context
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import decode_step, init_cache, prefill

D = os.environ["CASE_DIR"]


def nest(flat):
    out = {}
    for k, v in flat.items():
        *dirs, last = k.split("/")
        node = out
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = v
    return out


def main():
    mesh = make_local_mesh(2, 2, device="cpu")
    rules = ShardingRules(batch=("data",), fsdp=(), tp=("model",),
                          sp=("model",), flash_decode=True)
    toks = np.load(f"{D}/tokens.npy")
    out = {}
    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(ARCHS["chatglm3-6b"].reduced(), vocab=128,
                                  kv_cache_dtype=kv)
        model = lm_params_from_reference(
            nest(dict(np.load(f"{D}/params_{kv}.npz"))), cfg, device="cpu")
        with sharding_context(mesh, rules):
            fresh = init_cache(cfg, 2, 32, device="cpu")
            logits, cache = prefill(model, cfg, {"tokens": toks[:, :14]}, 32)
            shapes = [list(v.shape) for v in cache["blocks"]["b0"].values()]
            assert shapes == [list(v.shape) for v in
                              fresh["blocks"]["b0"].values()]
            steps = []
            before = fsdp.COUNTS["all_reduce"]
            for i in range(4):
                lg, cache = decode_step(model, cfg, cache,
                                        toks[:, 14 + i:15 + i], 14 + i)
                steps.append(lg.numpy().tolist())
        out[kv] = {"prefill": logits.numpy().tolist(), "steps": steps,
                   "cache_shapes": shapes,
                   "reductions": fsdp.COUNTS["all_reduce"] - before}
    return out
"""


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                         (B, PROMPT + STEPS), 0, 128))
    np.save(d / "tokens.npy", toks.astype(np.int32))
    ref = {}
    for kv in KV:
        cfg = dataclasses.replace(REF_ARCHS["chatglm3-6b"].reduced(),
                                  vocab=128, kv_cache_dtype=kv)
        params, _ = ref_model.init_model(cfg, jax.random.PRNGKey(0))
        np.savez(d / f"params_{kv}.npz", **_flat(params))
        lg, cache = ref_model.prefill(params, cfg,
                                      {"tokens": jnp.asarray(toks[:, :PROMPT])},
                                      T)
        steps = []
        for i in range(STEPS):
            out, cache = ref_model.decode_step(
                params, cfg, cache, jnp.asarray(toks[:, PROMPT + i:][:, :1]),
                jnp.int32(PROMPT + i))
            steps.append(np.asarray(out))
        ref[kv] = {"prefill": np.asarray(lg), "steps": steps,
                   "n_layers": cfg.n_layers}
    got = run_ranks(_RANKS, 4, d, env={"CASE_DIR": str(d)})
    return ref, got


@pytest.mark.parametrize("kv", KV)
def test_flash_decode_matches_the_plain_decode(runs, kv):
    ref, got = runs
    scale = max(1.0, float(np.abs(ref[kv]["steps"][-1]).max()))
    np.testing.assert_allclose(np.array(got[kv]["prefill"]),
                               ref[kv]["prefill"], rtol=0,
                               atol=TOL[kv] * scale)
    for i, want in enumerate(ref[kv]["steps"]):
        diff = float(np.abs(np.array(got[kv]["steps"][i]) - want).max())
        assert diff <= TOL[kv] * scale, (i, diff, scale)


@pytest.mark.parametrize("kv", KV)
def test_each_rank_holds_its_block_of_the_cache(runs, kv):
    """Rows 1 of 2, positions 16 of 32 (int8: codes and scales) of each
    of the 2 layers; one MAX and two SUM all-reduces per attention layer
    and step, and, ``tp`` splitting the MLP and the vocabulary beside
    flash-decoding, one per MLP and one for the embedding's rows."""
    ref, got = runs
    want = [[2, 1, 16, 2, 16], [2, 1, 16, 2, 16]]
    if kv == "int8":
        want += [[2, 1, 16, 2, 1], [2, 1, 16, 2, 1]]
    assert sorted(got[kv]["cache_shapes"]) == sorted(want)
    assert got[kv]["reductions"] == (4 * ref[kv]["n_layers"] + 1) * STEPS
