"""Training under tensor and sequence parallelism against the JAX
package on the CPU, float32.

- Two steps of the reference's single-device ``make_train_step`` and
  of the port's on a (2, 2) mesh of four gloo ranks with the launcher's
  rules (``batch``/``fsdp`` on ``data``, ``tp`` on ``model``), from the
  same parameters and batches, for chatglm3-6b, jamba reduced to one
  period at ``capacity_factor`` 0.25 (assignments drop) and xlstm-125m
  reduced: each step's loss, LM loss, aux loss and gradient norm within
  rtol 1e-5, as ``tests/test_torch_lm_mesh.py``'s data-parallel steps,
  and every parameter after the two steps at that file's bound (none
  more than lr/2 from the reference's, at most one element in a
  thousand more than 1e-3·lr: Adam moves an element whose gradient is
  near zero by up to lr on that gradient's last ulps).  Each rank holds
  about a quarter of the parameters.
- ``sp_act`` on a (1, 2) mesh (``tp=sp_act=("model",)``, the stream
  split along the sequence): the loss and every gradient leaf of
  chatglm3-6b, jamba (one period), xlstm-125m, whisper-small (the
  encoder's stream cut, ``enc_out`` gathered for the cross-attention
  with its gradient reduce-scattered) and qwen2-vl-2b (the patches
  joined to the tokens, then cut) reduced against ``jax.grad`` of the
  reference's ``loss_fn``, each leaf within 2e-5 of its largest
  element, the backward run on a thread of its own (as autograd's
  device thread on the card, which the sharding context does not reach:
  remat's recompute must carry it).  With the norms' gradients left
  unsummed over ``sp_act`` (the second trap: a norm reads only the
  rank's block of the sequence) the norms' gradients leave that bound.
- ``forward``'s logits on the (2, 2) mesh carry their gradient: every
  gradient leaf of ``sum(logits * W) + aux`` for a fixed random ``W``
  (the vocabulary blocks and the batch rows gathered, the gradient cut
  back to each rank's block and rows) against ``jax.grad`` of the same
  function of the reference's ``forward``, within 2e-5 of each leaf's
  largest element, for chatglm3-6b and xlstm-125m (tied embedding)
  reduced.
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as ref_model
from repro.training import optim as ref_optim
from repro.training import train as ref_train
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_reference
from repro_torch.models.model import FRONTEND_DIM

from _torch_ranks import run_ranks

LR = 1e-3
CASES = {"chatglm3-6b": {},
         "jamba-v0.1-52b": {"capacity_factor": 0.25, "n_layers": 8},
         "xlstm-125m": {}}
# sp_act: every arch the reference's pick_rules gives it to (attention),
# the two with frontends among them.
SP_CASES = {**CASES, "qwen2-vl-2b": {}, "whisper-small": {}}
LOGIT_CASES = {"chatglm3-6b": {}, "xlstm-125m": {}}
_KEYS = ("loss", "lm_loss", "aux_loss", "grad_norm")
_STEP_TOL = 1e-5
_GRAD_TOL = 2e-5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a).copy(), tree)


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def _batches(cfg, B=4, S=8, seed=3, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        b["labels"][0, :5] = -1
        if cfg.frontend == "vision":        # 4 patches: 12 positions
            b["patches"] = rng.standard_normal(
                (B, 4, FRONTEND_DIM["vision"])).astype(np.float32)
        if cfg.frontend == "audio":
            b["frames"] = rng.standard_normal(
                (B, 16, FRONTEND_DIM["audio"])).astype(np.float32)
        out.append(b)
    return out


_RANKS = """
import dataclasses
import threading
import numpy as np
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_reference
from repro_torch.dist import fsdp, place_params, tp
from repro_torch.dist.sharding import ShardingRules, sharding_context
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import forward, loss_fn, param_specs
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

D = os.environ["CASE_DIR"]
spec = json.load(open(f"{D}/cases.json"))


def nest(flat):
    out = {}
    for k, v in flat.items():
        *dirs, last = k.split("/")
        node = out
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = v
    return out


def model_of(arch, over):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **over)
    params = nest(dict(np.load(f"{D}/{arch}_params.npz")))
    return cfg, lm_params_from_reference(params, cfg, device="cpu")


def train(arch, over):
    mesh = make_local_mesh(2, 2, device="cpu")
    rules = ShardingRules(batch=("pod", "data"), fsdp=("data",))
    cfg, model = model_of(arch, over)
    model.requires_grad_(True)
    ocfg = AdamWConfig(lr=spec["lr"], warmup_steps=0)
    batches = [dict(np.load(f"{D}/{arch}_batch{i}.npz")) for i in range(2)]
    with sharding_context(mesh, rules):
        place_params(model, param_specs(cfg), mesh, rules)
        held = sum(p.to_local().numel() for p in model.parameters())
        opt = init_opt_state(model, ocfg)
        step = make_train_step(cfg, ocfg)
        metrics = []
        for b in batches:
            model, opt, m = step(model, opt, b)
            metrics.append({k: float(v) for k, v in m.items()})
        named = {k: fsdp.full_value(p).detach().numpy()
                 for k, p in model.named_parameters()}
    if RANK == 0:
        np.savez(f"{D}/{arch}_after.npz", **named)
    return {"metrics": metrics, "held": held,
            "total": sum(p.numel() for p in model.parameters())}


def grads(arch, over, trap):
    mesh = make_local_mesh(1, 2, device="cpu")
    rules = ShardingRules(batch=("data",), fsdp=("data",), tp=("model",),
                          sp_act=("model",))
    cfg, model = model_of(arch, over)
    model.requires_grad_(True)
    b = dict(np.load(f"{D}/{arch}_batch0.npz"))
    if trap:
        tp._NORM_SUFFIXES = ()
    with sharding_context(mesh, rules):
        place_params(model, param_specs(cfg), mesh, rules)
        loss, m = loss_fn(model, cfg, b)
        named = dict(model.named_parameters())
        # The backward on a thread of its own, as autograd's device
        # thread on the card, which the sharding context (a context
        # variable) does not reach: remat's recompute must carry it.
        box = {}
        t = threading.Thread(target=lambda: box.update(
            g=torch.autograd.grad(loss, list(named.values()))))
        t.start()
        t.join()
        out = {k: fsdp.full_value(g).numpy()
               for k, g in zip(named, box["g"])}
    tp._NORM_SUFFIXES = ("_scale", "_bias")
    if RANK == 0:
        np.savez(f"{D}/{arch}_grads{'_trap' if trap else ''}.npz", **out)
    return {"loss": float(loss), "lm_loss": float(m["lm_loss"]),
            "aux_loss": float(m["aux_loss"])}


def logit_grads(arch, over):
    # forward()'s logits, differentiated through the gathers of the
    # vocabulary blocks and of the batch rows.
    mesh = make_local_mesh(2, 2, device="cpu")
    rules = ShardingRules(batch=("pod", "data"), fsdp=("data",))
    cfg, model = model_of(arch, over)
    model.requires_grad_(True)
    b = dict(np.load(f"{D}/{arch}_batch0.npz"))
    w = torch.from_numpy(np.load(f"{D}/{arch}_w.npy"))
    with sharding_context(mesh, rules):
        place_params(model, param_specs(cfg), mesh, rules)
        logits, aux = forward(model, cfg, b)
        named = dict(model.named_parameters())
        g = torch.autograd.grad((logits * w).sum() + aux,
                                list(named.values()))
        out = {k: fsdp.full_value(v).numpy() for k, v in zip(named, g)}
    if RANK == 0:
        np.savez(f"{D}/{arch}_logit_grads.npz", **out)
    return {"vocab": int(logits.shape[-1])}


def main():
    if spec["mode"] == "train":
        return {"train": {a: train(a, o) for a, o in spec["cases"].items()},
                "logits": {a: logit_grads(a, o)
                           for a, o in spec["logit_cases"].items()}}
    return {a: {"grads": grads(a, o, False), "trap": grads(a, o, True)}
            for a, o in spec["cases"].items()}
"""


def _setup(d, arch, over):
    rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(), **over)
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **over)
    params = _np(ref_model.init_model(rcfg, jax.random.PRNGKey(0))[0])
    np.savez(d / f"{arch}_params.npz", **_flat(params))
    b = _batches(cfg)
    for i, bi in enumerate(b):
        np.savez(d / f"{arch}_batch{i}.npz", **bi)
    return rcfg, cfg, params, b


def _grads_as_port(g, cfg):
    return {k: v.detach().numpy() for k, v in lm_params_from_reference(
        _np(g), cfg, device="cpu").named_parameters()}


def _logit_grads(d, arch, rcfg, cfg, params, b):
    """``jax.grad`` of ``sum(forward(...)[0] * W) + aux`` on batch ``b``
    (``W`` written for the ranks), as the port's leaves."""
    w = np.random.default_rng(7).standard_normal(
        b["labels"].shape + (cfg.vocab,)).astype(np.float32)
    np.save(d / f"{arch}_w.npy", w)
    batch = {k: jnp.asarray(v) for k, v in b.items()}

    def objective(p):
        lg, aux = ref_model.forward(p, rcfg, batch)
        return jnp.sum(lg * jnp.asarray(w)) + aux

    return _grads_as_port(jax.grad(objective)(
        jax.tree.map(jnp.asarray, params)), cfg)


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_train")
    ref, logits = {}, {}
    for arch, over in CASES.items():
        rcfg, cfg, params, b = _setup(d, arch, over)
        if arch in LOGIT_CASES:
            logits[arch] = {"want": _logit_grads(d, arch, rcfg, cfg,
                                                 params, b[0])}
        rocfg = ref_optim.AdamWConfig(lr=LR, warmup_steps=0)
        step = ref_train.make_train_step(rcfg, rocfg)
        rp = jax.tree.map(jnp.asarray, params)
        ropt = ref_optim.init_opt_state(rp, rocfg)
        metrics = []
        for bi in b:
            rp, ropt, m = step(rp, ropt, {k: jnp.asarray(v)
                                          for k, v in bi.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        want = {k: v.detach().numpy() for k, v in lm_params_from_reference(
            _np(rp), cfg, device="cpu").named_parameters()}
        ref[arch] = {"metrics": metrics, "want": want, "cfg": cfg}
    (d / "cases.json").write_text(json.dumps(
        {"mode": "train", "cases": CASES, "lr": LR,
         "logit_cases": LOGIT_CASES}))
    got = run_ranks(_RANKS, 4, d, env={"CASE_DIR": str(d)}, timeout=400)
    for arch in CASES:
        ref[arch]["got"] = got["train"][arch]
        ref[arch]["after"] = dict(np.load(d / f"{arch}_after.npz"))
    for arch in LOGIT_CASES:
        logits[arch]["got"] = got["logits"][arch]
        logits[arch]["grads"] = dict(np.load(d / f"{arch}_logit_grads.npz"))
    return {**ref, "logits": logits}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_tp_steps_match_the_reference(train_run, arch):
    run = train_run[arch]
    for m, r in zip(run["got"]["metrics"], run["metrics"]):
        for k in _KEYS:
            np.testing.assert_allclose(m[k], r[k], rtol=_STEP_TOL,
                                       atol=1e-7, err_msg=k)
    n_far = n_all = 0
    for name, w in run["want"].items():
        diff = np.abs(run["after"][name] - w)
        assert diff.max() <= LR / 2, name
        n_far += int((diff > 1e-3 * LR).sum())
        n_all += diff.size
    assert n_far <= n_all // 1000, (n_far, n_all)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_each_rank_holds_about_a_quarter(train_run, arch):
    """On the (2, 2) mesh a leaf split over both ``fsdp`` and ``tp`` is
    held a quarter on each rank, one split over one of them half."""
    got = train_run[arch]["got"]
    assert got["held"] < 0.4 * got["total"], got


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_sp")
    ref = {}
    for arch, over in SP_CASES.items():
        rcfg, cfg, params, b = _setup(d, arch, over)
        batch = {k: jnp.asarray(v) for k, v in b[0].items()}

        def loss(p):
            return ref_model.loss_fn(p, rcfg, batch)

        (value, metrics), g = jax.value_and_grad(loss, has_aux=True)(
            jax.tree.map(jnp.asarray, params))
        ref[arch] = {"loss": float(value), "want": _grads_as_port(g, cfg),
                     "lm_loss": float(metrics["lm_loss"]),
                     "aux_loss": float(metrics["aux_loss"])}
    (d / "cases.json").write_text(json.dumps({"mode": "sp",
                                              "cases": SP_CASES}))
    got = run_ranks(_RANKS, 2, d, env={"CASE_DIR": str(d)}, timeout=400)
    for arch in SP_CASES:
        ref[arch]["got"] = got[arch]
        ref[arch]["grads"] = dict(np.load(d / f"{arch}_grads.npz"))
        ref[arch]["trap"] = dict(np.load(d / f"{arch}_grads_trap.npz"))
    return ref


def _leaf_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-12)


@pytest.mark.parametrize("arch", sorted(SP_CASES))
def test_sp_act_loss_and_every_gradient_leaf(sp_run, arch):
    run = sp_run[arch]
    for k in ("loss", "lm_loss", "aux_loss"):
        np.testing.assert_allclose(run["got"]["grads"][k], run[k],
                                   rtol=_STEP_TOL, atol=1e-7, err_msg=k)
    assert sorted(run["grads"]) == sorted(run["want"])
    for name, w in run["want"].items():
        assert _leaf_err(run["grads"][name], w) <= _GRAD_TOL, name


@pytest.mark.parametrize("arch", sorted(SP_CASES))
def test_unsummed_norm_gradients_are_caught(sp_run, arch):
    """The second trap planted: the norms' gradients cover the rank's
    block of the sequence only, and leave the bound; the loss does not
    move."""
    run = sp_run[arch]
    np.testing.assert_allclose(run["got"]["trap"]["loss"], run["loss"],
                               rtol=_STEP_TOL)
    norms = [n for n in run["want"]
             if re.search(r"(ln1|ln2|lnx|norm_f|norm_enc)_(scale|bias)$", n)
             and np.abs(run["want"][n]).max() > 0]
    assert norms
    assert all(_leaf_err(run["trap"][n], run["want"][n]) > 100 * _GRAD_TOL
               for n in norms)


@pytest.mark.parametrize("arch", sorted(LOGIT_CASES))
def test_forward_logits_carry_their_gradient_under_tp(train_run, arch):
    """``forward`` gathers the vocabulary blocks and the batch rows
    differentiably: the gradient of a function of its full logits
    reaches every parameter as the reference's does (a gather without a
    gradient leaves the logits out of the graph)."""
    run = train_run["logits"][arch]
    assert run["got"]["vocab"] == ARCHS[arch].reduced().vocab
    assert sorted(run["grads"]) == sorted(run["want"])
    for name, w in run["want"].items():
        assert _leaf_err(run["grads"][name], w) <= _GRAD_TOL, name
