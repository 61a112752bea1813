"""Manual expert parallelism against the JAX package's, on the CPU.

``tests/test_moe_ep.py``'s layer (8 experts, top 2, capacity factor 8:
nothing drops) on a (2, 2) mesh: the reference's ``moe_forward(...,
impl="ep")`` in a child process with 4 host devices, the port's in four
gloo ranks, each on its rows of the batch (``data``) with its 4 of the 8
experts (``ep`` on ``model``).  The output, put back together from the
ranks, within 1e-4·max(1, max|ref|) of the reference's; the aux loss,
group-local over the same data shards and averaged over them, within
1e-6.  Again with the experts also split over ``data`` (``fsdp``),
gathered back per layer.  The gradients of a loss on the output, of the
input rows and of every parameter, within 1e-4·max(1, max|g|) of the
one-device ``scatter`` path's: expert parallelism sums the input's and
the router's gradients over the ``ep`` ranks.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_ranks import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CFG = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=0, vocab=64, moe=True, n_experts=8, top_k=2,
            moe_d_ff=16, capacity_factor=8.0, param_dtype="float32")

_REF = """
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ModelConfig
from repro.dist.sharding import ShardingRules, sharding_context
from repro.launch.mesh import make_local_mesh
from repro.models.layers import Param
from repro.models.moe import init_moe, moe_forward

cfg = ModelConfig(**{cfg!r})
p = Param(jax.random.PRNGKey(0), jnp.float32)
init_moe(p, cfg)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32))
mesh = make_local_mesh(data=2, model=2)
rules = ShardingRules(batch=("data",), fsdp=(), tp=("model",), ep=("model",))
with sharding_context(mesh, rules):
    out, aux = jax.jit(lambda pp, xx: moe_forward(
        pp, cfg, xx, impl="ep", dtype=jnp.float32))(p.params, x)
np.savez({out!r}, x=np.asarray(x), out=np.asarray(out), aux=np.asarray(aux),
         **{{k: np.asarray(v) for k, v in p.params.items()}})
"""

_RANKS = """
import numpy as np
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import fsdp, place_params
from repro_torch.dist.sharding import ShardingRules, sharding_context
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.layers import Params
from repro_torch.models.moe import gather_moe, init_moe, moe_forward

D = os.environ["CASE_DIR"]
cfg = ModelConfig(**json.loads(os.environ["CFG"]))
ref = dict(np.load(f"{D}/ref.npz"))


def layer():
    p = Params(torch.float32, torch.device("cpu"))
    init_moe(p, cfg)
    with torch.no_grad():
        for n, t in p.named_parameters():
            t.copy_(torch.from_numpy(ref[n]))
    return p.requires_grad_(True)


def main():
    mesh = make_local_mesh(2, 2, device="cpu")
    x = torch.from_numpy(ref["x"])
    wts = torch.from_numpy(np.random.default_rng(2).standard_normal(
        x.shape).astype(np.float32))
    # One device, scatter: the gradients' reference.
    one = layer()
    xs = x.clone().requires_grad_(True)
    y, _ = moe_forward(one, cfg, xs, impl="scatter", dtype=torch.float32)
    g_one = torch.autograd.grad((y * wts).sum(),
                                [xs] + list(one.parameters()))
    out = {}
    for label, fsdp_axes in (("ep", ()), ("ep+fsdp", ("data",))):
        rules = ShardingRules(batch=("data",), fsdp=fsdp_axes,
                              tp=("model",), ep=("model",))
        p = layer()
        with sharding_context(mesh, rules):
            place_params(p, p.specs, mesh, rules)
            own = p.w_gate.to_local().shape[0]
            xl = fsdp.batch_block(x, mesh, rules).clone().requires_grad_(True)
            view = gather_moe(p, mesh, rules, ep=True)
            y, aux = moe_forward(view, cfg, xl, impl="ep",
                                 dtype=torch.float32)
            wl = fsdp.batch_block(wts, mesh, rules)
            g = torch.autograd.grad((y * wl).sum(), [xl] + list(p.parameters()))
            full = fsdp.gather_rows(y.detach(), mesh, rules)
            gx = fsdp.gather_rows(g[0], mesh, rules)
            gp = [fsdp.full_value(t) for t in g[1:]]
        gerr = [float((a - b).abs().max() / max(1.0, float(b.abs().max())))
                for a, b in zip([gx] + gp, g_one)]
        out[label] = {"out": full.numpy().tolist(), "aux": float(aux),
                      "own_experts": own, "grad_rel_err": gerr}
    return out
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    script = textwrap.dedent(_REF.format(src=str(ROOT / "src"), cfg=_CFG,
                                         out=str(d / "ref.npz")))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(d / "ref.npz"))
    got = run_ranks(_RANKS, 4, d, env={"CASE_DIR": str(d),
                                       "CFG": json.dumps(_CFG)})
    return ref, got


@pytest.mark.parametrize("label", ["ep", "ep+fsdp"])
def test_manual_ep_matches_the_reference(runs, label):
    ref, got = runs
    scale = max(1.0, float(np.abs(ref["out"]).max()))
    diff = float(np.abs(np.array(got[label]["out"]) - ref["out"]).max())
    assert diff <= 1e-4 * scale, diff
    assert abs(got[label]["aux"] - float(ref["aux"])) <= 1e-6
    assert got[label]["own_experts"] == 4


@pytest.mark.parametrize("label", ["ep", "ep+fsdp"])
def test_manual_ep_gradients_are_the_one_device_ones(runs, label):
    _, got = runs
    errs = got[label]["grad_rel_err"]
    assert len(errs) == 5 and max(errs) <= 1e-4, errs
