"""The port's collectives against the JAX package's, on gloo ranks.

One spawned run of 4 CPU ranks (``_torch_ranks.run_ranks``) drives both
functions: ``bucketed_psum`` over the 2-rank ``data`` groups of a 2x2
mesh, and ``compress_psum`` over a 4-rank mesh for 8 steps of error
feedback.  The reference's functions run in this process under
``jax.vmap`` with a named axis, which gives their collectives (``psum``,
``pmax``, ``all_gather``) the same 4-member axis on one device.  The
inputs come from one numpy seed.  The bucketed sum must be exact, and
each compressed step's mean and residual must equal the reference's
within 1e-6 (both packages divide by the same float32 scale and round
half to even; 1e-6 leaves room for the order of the int32-to-float32
sum, not for one code off, which moves the mean by scale / 4 ~ 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ranks import run_ranks
from repro.dist.collectives import compress_psum as j_compress_psum

STEPS = 8
RANKS = 4


def _grads():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((RANKS, 1, 64)) * 3.0).astype(np.float32)


_BODY = """
import numpy as np
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.dist import (ShardingRules, bucketed_psum, compress_psum,
                              sharding_context)

G = np.load({grads!r})


def main():
    res = {{}}
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    i = mesh.get_local_rank("data")
    full = {{"a": torch.arange(8.0).reshape(2, 4), "b": torch.ones((2, 3)),
             "c": torch.full((2, 1), 2.0),
             "d": torch.arange(6, dtype=torch.int32).reshape(2, 3)}}
    mine = {{k: v[i:i + 1] for k, v in full.items()}}
    with sharding_context(mesh, ShardingRules()):
        out = bucketed_psum(mine, "data", min_bucket_bytes=16)
    res["bucket_diff"] = max(
        float((out[k] - full[k].sum(0, keepdim=True)).abs().max())
        for k in full)
    res["bucket_dtypes"] = all(out[k].dtype == full[k].dtype for k in full)
    res["inputs_kept"] = all(torch.equal(mine[k], full[k][i:i + 1])
                             for k in full)

    line = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    g = torch.from_numpy(G[RANK])
    e = torch.zeros_like(g)
    means, resid = [], []
    with sharding_context(line, ShardingRules()):
        for _ in range({steps}):
            out, err = compress_psum({{"g": g}}, "data", {{"g": e}})
            e = err["g"]
            means.append(out["g"].reshape(-1).tolist())
            every = [torch.empty_like(e) for _ in range(WORLD)]
            dist.all_gather(every, e)
            resid.append(torch.stack(every).reshape(WORLD, -1).tolist())
    res["means"], res["resid"] = means, resid
    return res
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    np.save(tmp / "grads.npy", _grads())
    return run_ranks(_BODY.format(grads=str(tmp / "grads.npy"),
                                  steps=STEPS), RANKS, tmp)


def test_bucketed_psum_is_exact(ranks):
    assert ranks["bucket_diff"] == 0.0
    assert ranks["bucket_dtypes"] and ranks["inputs_kept"]


def test_compress_psum_steps_equal_the_reference(ranks):
    def step(g, e):
        out, new_e = j_compress_psum({"g": g}, "data", {"g": e})
        return out["g"], new_e["g"]

    vstep = jax.vmap(step, axis_name="data")
    g = jnp.asarray(_grads())
    e = jnp.zeros_like(g)
    for k in range(STEPS):
        out, e = vstep(g, e)
        np.testing.assert_allclose(ranks["means"][k],
                                   np.asarray(out[0]).reshape(-1),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(ranks["resid"][k],
                                   np.asarray(e).reshape(RANKS, -1),
                                   rtol=0, atol=1e-6)


def test_compress_psum_error_feedback_converges(ranks):
    """The reference's own two assertions, on the port's outputs."""
    true_mean = _grads().mean(axis=0).reshape(-1)
    means = np.asarray(ranks["means"])
    err_one = float(np.abs(means[-1] - true_mean).max())
    err_avg = float(np.abs(means.mean(axis=0) - true_mean).max())
    scale = float(np.abs(true_mean).max())
    assert err_one < 0.1 * scale + 0.05
    assert err_avg < err_one / 2


@pytest.mark.parametrize("name", ["bucketed_psum", "compress_psum"])
def test_collectives_need_a_context(name):
    import torch

    import repro_torch.dist as tdist

    x = {"g": torch.ones(3)}
    args = (x, "data") if name == "bucketed_psum" else (x, "data", x)
    with pytest.raises(RuntimeError, match="sharding_context"):
        getattr(tdist, name)(*args)
