"""The LM stack under a mesh against the JAX package on the CPU.

- Specs and shapes: ``param_specs``, ``abstract_params`` and
  ``opt_state_specs`` equal the reference's for all 10 architectures at
  full size, leaf for leaf through the layer <-> ``(period, slot)`` map
  (a port block leaf's spec is the reference's without its leading
  ``"null"``, its shape without the stacked axis); the meta-device model
  allocates nothing, kimi-k2-1t included.
- ``make_production_mesh`` on a fake process group of 256 and 512 ranks,
  and chatglm3-6b's specs resolved on it as the reference's on a
  stand-in 16x16 mesh; a world of one raises.
- Training, float32, chatglm3-6b reduced and jamba reduced to one
  period: a step on a 1x1 mesh is bitwise the step without one; two
  steps on a ``data=2`` mesh of two gloo ranks (the labelled tokens
  uneven between the ranks; chatglm3-6b with int8 moments, jamba at a
  capacity where assignments drop) against the reference's
  single-device ``make_train_step`` on the same parameters and batches:
  each step's loss, LM loss, aux loss and gradient norm within rtol 1e-5
  (4e-7 measured), the int8 moments' scales within rtol 1e-4, and with
  float32 moments the parameters after two steps at
  ``tests/test_torch_train_step.py``'s bound for the one-device port:
  none more than lr/2 from the reference's and at most one element in a
  thousand more than 1e-3·lr.  Adam divides each update by the root of
  its second moment, so an element whose gradient is near zero moves by
  up to lr on the last ulps of that gradient: chatglm3-6b measured
  1.40e-4 (0.14·lr; 39 of 107072 elements beyond 1e-3·lr) on the mesh
  and 9.3e-5 (38) on one device, so no bound of 1e-5 relative holds for
  either.  With int8 moments an element whose moment rounds to zero
  moves by up to 1e3·lr (jamba measured 1.16 on one device), so there
  the parameters are held through the second step's loss only.  With
  the gradient's placements left at ``Replicate()``
  (``to_local()``'s default, the trap of a straightforward FSDP port)
  the gradient norm leaves the bound.
- Elastic checkpoint: the state saved on the two ranks restores on one
  process and on the two ranks bitwise.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as REF_ARCHS
from repro.dist import sharding as jsh
from repro.models import model as ref_model
from repro.training import optim as ref_optim
from repro.training import train as ref_train
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_reference
from repro_torch.dist import sharding as tsh
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import model as tmodel
from repro_torch.training import AdamWConfig, init_opt_state, \
    make_train_step, opt_state_specs

from _torch_ranks import run_ranks

LR = 1e-3


# ----------------------------------------------------------------------
# Specs and shapes
# ----------------------------------------------------------------------

def _ref_by_port_name(tree, cfg, strip):
    """``{port name: leaf}`` of a reference tree (``blocks/b{j}`` stacked
    over periods, ``enc_blocks/b0`` over encoder layers); ``strip`` maps
    a stacked leaf to one layer's."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict) and not (set(node) == {"q", "s"}
                                           and path[0] in ("m", "v")):
            for k, v in node.items():
                walk(v, path + (k,))
            return
        head = path[0] if path[0] not in ("m", "v") else path[1]
        pre = path[:1] if path[0] in ("m", "v") else ()
        rest = path[len(pre):]
        if head not in ("blocks", "enc_blocks"):
            out[".".join(pre + rest)] = node
            return
        j = int(rest[1].removeprefix("b"))
        n = cfg.n_periods if head == "blocks" else cfg.n_enc_layers
        for idx in range(n):
            i = idx * cfg.period + j if head == "blocks" else idx
            stack = "layers" if head == "blocks" else "enc_layers"
            out[".".join(pre + (stack, str(i)) + rest[2:])] = strip(node,
                                                                    idx)

    walk(tree, ())
    return out


def _strip_spec(node, idx=None):
    if isinstance(node, dict):
        return {k: tuple(v)[1:] for k, v in node.items()}
    return tuple(node)[1:]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch):
    cfg = ARCHS[arch]
    want = _ref_by_port_name(ref_model.param_specs(REF_ARCHS[arch]), cfg,
                             _strip_spec)
    got = tmodel.param_specs(cfg)
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_equal_the_reference(arch):
    cfg = ARCHS[arch]
    ref = _ref_by_port_name(ref_model.abstract_params(REF_ARCHS[arch]), cfg,
                            lambda a, _: jax.ShapeDtypeStruct(a.shape[1:],
                                                              a.dtype))
    model = tmodel.abstract_params(cfg)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(ref)
    for name, p in got.items():
        assert p.device.type == "meta"
        assert tuple(p.shape) == tuple(ref[name].shape), name
        assert str(p.dtype).removeprefix("torch.") == ref[name].dtype.name
    assert sum(p.numel() for p in got.values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(
            ref_model.abstract_params(REF_ARCHS[arch])))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_opt_state_specs_equal_the_reference(state_dtype):
    cfg = ARCHS["jamba-v0.1-52b"]
    ref = ref_optim.opt_state_specs(ref_model.param_specs(
        REF_ARCHS["jamba-v0.1-52b"]), state_dtype)
    got = opt_state_specs(tmodel.param_specs(cfg), state_dtype)
    assert got["step"] == tuple(ref["step"])
    for k in ("m", "v"):
        want = _ref_by_port_name({k: ref[k]}, cfg, _strip_spec)
        assert {f"{k}.{n}": v for n, v in got[k].items()} == {
            n: (v if isinstance(v, dict) else tuple(v))
            for n, v in want.items()}


def test_model_facade_as_the_reference():
    cfg = ARCHS["xlstm-125m"].reduced()
    m = tmodel.build_model(cfg, seed=0, device="cpu")
    rm = ref_model.Model(REF_ARCHS["xlstm-125m"].reduced(), None, None)
    assert repr(m) == repr(rm)
    assert m.specs == tmodel.param_specs(cfg)
    assert set(m.specs) == {n for n, _ in m.params.named_parameters()}
    assert {"Model", "build_model", "param_specs",
            "abstract_params"} <= set(tmodel.__all__)


# ----------------------------------------------------------------------
# The production mesh
# ----------------------------------------------------------------------

@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_world(fake_world, multi_pod):
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    if multi_pod:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        return
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (16, 16)
    # chatglm3-6b's parameters resolve as the reference's on its mesh.
    rules = tsh.ShardingRules(batch=("pod", "data"), fsdp=("data",))
    jrules = jsh.ShardingRules(batch=("pod", "data"), fsdp=("data",))
    jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": 16, "model": 16})
    cfg = ARCHS["chatglm3-6b"]
    jspecs = _ref_by_port_name(ref_model.param_specs(REF_ARCHS[
        "chatglm3-6b"]), cfg, lambda s, _: s)
    jshapes = {k: tuple(a.shape) for k, a in _ref_by_port_name(
        ref_model.abstract_params(REF_ARCHS["chatglm3-6b"]), cfg,
        lambda a, _: a).items()}
    n_split = 0
    for name, p in tmodel.abstract_params(cfg).named_parameters():
        spec = tmodel.param_specs(cfg)[name]
        got = tsh.valid_spec(tuple(p.shape), tsh.logical_to_spec(
            spec, rules, mesh), mesh)
        want = tuple(jsh.valid_spec(jshapes[name], jsh.logical_to_spec(
            jspecs[name], jrules, jmesh), jmesh))
        stacked = len(jshapes[name]) > p.ndim
        assert got == (want[1:] if stacked else want), name
        n_split += any(e is not None for e in got)
    assert n_split > 0


def test_production_mesh_refuses_a_world_of_one():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs a world of 256 ranks, not 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="world of 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")


# ----------------------------------------------------------------------
# Training on a mesh
# ----------------------------------------------------------------------

def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a).copy(), tree)


def _batches(cfg, B=4, S=8, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        b["labels"][0, :5] = -1          # rank 0's rows: fewer labels
        out.append(b)
    return out


# arch: (moment dtype, config overrides): jamba one period deep, at a
# capacity at which assignments drop.
CASES = {"chatglm3-6b": ("int8", {}),
         "jamba-v0.1-52b": ("float32", {"capacity_factor": 0.25,
                                        "n_layers": 8})}


def _setup(arch):
    state_dtype, over = CASES[arch]
    rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(), **over)
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **over)
    params, _ = ref_model.init_model(rcfg, jax.random.PRNGKey(0))
    return rcfg, cfg, _np(params), state_dtype


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


_RANKS = """
import dataclasses
import numpy as np
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_reference
from repro_torch.dist import fsdp, place_params
from repro_torch.dist.sharding import ShardingRules, sharding_context
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import param_specs
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

D = os.environ["CASE_DIR"]
case = json.load(open(f"{D}/case.json"))


def nest(flat):
    out = {}
    for k, v in flat.items():
        *dirs, last = k.split("/")
        node = out
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = v
    return out


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [fsdp.local(tree)]


def main():
    cfg = dataclasses.replace(ARCHS[case["arch"]].reduced(), **case["over"])
    mesh = make_local_mesh(2, 1, device="cpu")
    rules = ShardingRules(batch=("pod", "data"), fsdp=("data",))
    ocfg = AdamWConfig(lr=case["lr"], warmup_steps=0,
                       state_dtype=case["state_dtype"])
    params = nest(dict(np.load(f"{D}/params.npz")))
    batches = [dict(np.load(f"{D}/batch{i}.npz")) for i in range(2)]
    out = {}
    for trap in (False, True):
        if trap:
            # The trap: gradients taken as each rank's own.
            from torch.distributed.tensor import Replicate
            fsdp.grad_placements = lambda mesh, rules, sum_axes=(): [
                Replicate()] * mesh.ndim
        model = lm_params_from_reference(params, cfg, device="cpu")
        model.requires_grad_(True)
        with sharding_context(mesh, rules):
            place_params(model, param_specs(cfg), mesh, rules)
            held = sum(p.to_local().numel() for p in model.parameters())
            opt = init_opt_state(model, ocfg)
            step = make_train_step(cfg, ocfg)
            metrics = []
            for b in (batches[:1] if trap else batches):
                model, opt, m = step(model, opt, b)
                metrics.append({k: float(v) for k, v in m.items()})
            if trap:
                out["trap"] = metrics
                break
            named = {k: fsdp.full_value(p).detach()
                     for k, p in model.named_parameters()}
            if ocfg.state_dtype == "int8":
                named.update({f"{k}.{n}.s": fsdp.full_value(opt[k][n]["s"])
                              for k in "mv" for n in opt[k]})
            if RANK == 0:
                np.savez(f"{D}/after.npz", **{k: v.numpy()
                                               for k, v in named.items()})
            save_checkpoint(f"{D}/ck", 2, {"params": model, "opt": opt})
            # Restore on the same mesh into a fresh placed template.
            fresh = lm_params_from_reference(params, cfg, device="cpu")
            place_params(fresh, param_specs(cfg), mesh, rules)
            tmpl = {"params": fresh, "opt": init_opt_state(fresh, ocfg)}
            load_checkpoint(f"{D}/ck", tmpl, in_place=True)
            same = all(torch.equal(a.to_local(), b.to_local())
                       for a, b in zip(fresh.parameters(),
                                       model.parameters()))
            same &= all(torch.equal(a, b) for a, b in zip(
                leaves(opt), leaves(tmpl["opt"])))
        out.update(metrics=metrics, restored_on_mesh=bool(same),
                   held=held, total=sum(p.numel() for p in model.parameters()))
    return out
"""


@pytest.fixture(scope="module", params=sorted(CASES))
def mesh_run(request, tmp_path_factory):
    """Two steps of the reference's ``make_train_step`` and of the
    port's on two gloo ranks, from the same parameters and batches."""
    arch = request.param
    rcfg, cfg, params, state_dtype = _setup(arch)
    d = tmp_path_factory.mktemp(arch)
    b = _batches(cfg)
    np.savez(d / "params.npz", **_flat(params))
    for i, bi in enumerate(b):
        np.savez(d / f"batch{i}.npz", **bi)
    over = CASES[arch][1]
    (d / "case.json").write_text(json.dumps(
        {"arch": arch, "over": over, "lr": LR, "state_dtype": state_dtype}))
    rocfg = ref_optim.AdamWConfig(lr=LR, warmup_steps=0,
                                  state_dtype=state_dtype)
    step = ref_train.make_train_step(rcfg, rocfg)
    rp = jax.tree.map(jnp.asarray, params)
    ropt = ref_optim.init_opt_state(rp, rocfg)
    ref_metrics = []
    for bi in b:
        rp, ropt, m = step(rp, ropt, {k: jnp.asarray(v)
                                      for k, v in bi.items()})
        ref_metrics.append({k: float(v) for k, v in m.items()})
    out = run_ranks(_RANKS, 2, d, env={"CASE_DIR": str(d)})
    want = {k: v.detach().numpy() for k, v in lm_params_from_reference(
        _np(rp), cfg, device="cpu").named_parameters()}
    if state_dtype == "int8":
        for k in "mv":
            want.update({f"{n}.s": q8["s"] for n, q8 in _ref_by_port_name(
                {k: _np(ropt[k])}, cfg,
                lambda a, i: {"s": a["s"][i]}).items()})
    got = dict(np.load(d / "after.npz"))
    return {"cfg": cfg, "dir": d, "ref": ref_metrics, "want": want,
            "got": got, "out": out, "params": params,
            "state_dtype": state_dtype,
            "params_named": [n for n in want if not n.endswith(".s")]}


_KEYS = ("loss", "lm_loss", "aux_loss", "grad_norm")
_STEP_TOL = 1e-5


def test_data_parallel_steps_match_the_reference(mesh_run):
    for m, r in zip(mesh_run["out"]["metrics"], mesh_run["ref"]):
        for k in _KEYS:
            np.testing.assert_allclose(m[k], r[k], rtol=_STEP_TOL,
                                       atol=1e-7, err_msg=k)
    got, want = mesh_run["got"], mesh_run["want"]
    if mesh_run["state_dtype"] == "int8":
        scales = [n for n in want if n.endswith(".s")]
        assert len(scales) == 2 * len(mesh_run["params_named"])
        for n in scales:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-4,
                                       atol=0, err_msg=n)
        return
    n_far = n_all = 0
    for name, w in want.items():
        d = np.abs(got[name] - w)
        assert d.max() <= LR / 2, name
        n_far += int((d > 1e-3 * LR).sum())
        n_all += d.size
    assert n_far <= n_all // 1000, (n_far, n_all)


def test_each_rank_holds_its_half_of_each_split_leaf(mesh_run):
    """A leaf whose ``fsdp`` dimension divides by 2 is held half on each
    rank; the others (norm scales, Mamba's ``tp``-only leaves) whole."""
    cfg, out = mesh_run["cfg"], mesh_run["out"]
    want = 0
    for name, p in tmodel.abstract_params(cfg).named_parameters():
        spec = tmodel.param_specs(cfg)[name]
        split = "fsdp" in spec and p.shape[spec.index("fsdp")] % 2 == 0
        want += p.numel() // 2 if split else p.numel()
    assert out["held"] == want < out["total"]


def test_rank_local_gradients_are_caught(mesh_run):
    """With ``to_local()``'s default placements the gradients are each
    rank's own: the gradient norm leaves the reference's bound."""
    (trap,), (ref, _) = mesh_run["out"]["trap"], mesh_run["ref"]
    np.testing.assert_allclose(trap["loss"], ref["loss"], rtol=_STEP_TOL)
    assert abs(trap["grad_norm"] - ref["grad_norm"]) \
        > 100 * _STEP_TOL * ref["grad_norm"]


def test_checkpoint_restores_across_meshes_bitwise(mesh_run):
    from repro_torch.ckpt import load_checkpoint

    assert mesh_run["out"]["restored_on_mesh"]
    cfg = mesh_run["cfg"]
    model = lm_params_from_reference(mesh_run["params"], cfg, device="cpu")
    ocfg = AdamWConfig(lr=LR, state_dtype=mesh_run["state_dtype"])
    tree = {"params": model, "opt": init_opt_state(model, ocfg)}
    _, step = load_checkpoint(str(mesh_run["dir"] / "ck"), tree,
                              in_place=True)
    assert step == 2
    for name, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), mesh_run["got"][name]), \
            name
    if mesh_run["state_dtype"] == "int8":
        for k in "mv":
            for name, q8 in tree["opt"][k].items():
                assert np.array_equal(q8["s"].numpy(),
                                      mesh_run["got"][f"{k}.{name}.s"])
    assert int(tree["opt"]["step"]) == 2


@pytest.mark.parametrize("arch", sorted(CASES))
def test_identity_mesh_step_is_the_one_device_step_bitwise(arch):
    """On a 1x1 mesh nothing is placed and no collective runs: the step
    is the one without a mesh, bit for bit."""
    from repro_torch.dist import fsdp, place_params

    _, cfg, params, state_dtype = _setup(arch)
    ocfg = AdamWConfig(lr=LR, warmup_steps=0, state_dtype=state_dtype)
    b = _batches(cfg)
    runs = []
    for meshed in (False, True):
        model = lm_params_from_reference(params, cfg, device="cpu")
        model.requires_grad_(True)
        opt = init_opt_state(model, ocfg)
        step = make_train_step(cfg, ocfg)
        if not meshed:
            for bi in b:
                model, opt, m = step(model, opt, bi)
            runs.append((model, m))
            continue
        mesh = make_local_mesh(1, 1, device="cpu")
        try:
            rules = tsh.ShardingRules()
            before = dict(fsdp.COUNTS)
            with tsh.sharding_context(mesh, rules):
                place_params(model, tmodel.param_specs(cfg), mesh, rules)
                for bi in b:
                    model, opt, m = step(model, opt, bi)
            assert fsdp.COUNTS == before
        finally:
            dist.destroy_process_group()
        runs.append((model, m))
    (m0, a), (m1, b_) = runs
    for k in _KEYS:
        assert float(a[k]) == float(b_[k]), k
    for (n, p), (_, q) in zip(m0.named_parameters(), m1.named_parameters()):
        assert type(q) is torch.nn.Parameter and torch.equal(p, q), n
