"""Tensor parallelism of the LM stack against the JAX package on the CPU.

Every architecture's ``reduced()`` config in float32 (chatglm3-6b also
with the int8 cache, jamba also at ``capacity_factor`` 0.25) on a (1, 2)
mesh of two gloo ranks with ``tp=("model",)``, from the reference's
seeded parameters placed on the mesh: the forward's logits and aux
loss, the prefill's logits and two decode steps' within rtol = atol =
2e-4 of ``repro.models.model`` on the same numpy inputs (1e-5 measured),
and each rank's prefill and decode caches within the same bound of its
block of the reference's (the rank's KV heads, Mamba channels, mLSTM
heads and sLSTM units, cut here by hand; int8 codes within 1).

The split is real, not computed whole and sliced: every ``dense`` call
is recorded with its input and output widths, and each ``tp``
projection runs at 1/tp of its width (column-parallel outputs, the
fused projections' outputs, row-parallel inputs), the logits at 1/tp of
the vocabulary, while the MoE layer, the router and the frontends run
whole.  The fused projections' per-rank cuts (Mamba's ``in_proj``,
mLSTM's ``qkv`` and ``gates``, sLSTM's gate-major ``zifo``) equal each
part's block of the reference's matrix, not a contiguous block of it.

Also on the (1, 2) mesh: flash-decoding beside ``tp``
(``tests/test_decode_sp.py``'s rules ``tp=sp=("model",)``): the
attention keeps its heads whole and the positions split, the MLP runs at
1/2 width, the logits against the reference's plain decode; the
vocabulary-parallel embedding (``take`` and ``onehot``, ids on both
sides of the block boundary and outside the vocabulary) and
cross-entropy (the loss and its gradient on the block) against the
unsplit ones; the divisibility guard: a vocabulary, an FFN width and
mLSTM heads that tp=2 does not divide run whole, at their full widths;
and ``init_model(mesh=, rules=)``, which places each parameter as it is
drawn, equal to a whole draw placed by ``place_params``.

chatglm3-6b reduced (2 KV heads) on a (1, 4) mesh: tp = 4 does not
divide the KV heads, so ranks 0-1 compute KV head 0 and ranks 2-3 KV
head 1, and the logits hold the reference's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.models import model as ref_model
from repro_torch.configs import ARCHS
from repro_torch.models.model import FRONTEND_DIM

from _torch_ranks import run_ranks

B, S, MAX_LEN = 2, 12, 24
N_PATCHES, N_FRAMES = 4, 16
TOL = dict(rtol=2e-4, atol=2e-4)
CASES = {a: {} for a in sorted(ARCHS)}
CASES["chatglm3-6b-int8"] = {"kv_cache_dtype": "int8"}
CASES["jamba-v0.1-52b-drop"] = {"capacity_factor": 0.25}
FLASH = "chatglm3-6b-flash"


def _arch(case: str) -> str:
    return next(a for a in sorted(ARCHS, key=len, reverse=True)
                if case.startswith(a))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = rng.standard_normal(
            (B, N_PATCHES, FRONTEND_DIM["vision"])).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (B, N_FRAMES, FRONTEND_DIM["audio"])).astype(np.float32)
    return batch


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        x = np.asarray(tree)
        return {prefix: x.astype(np.float32) if x.dtype.name == "bfloat16"
                else x}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


_RANKS = """
import dataclasses
import numpy as np
import repro_torch.kernels.slstm_ops as slstm_ops
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_reference
from repro_torch.dist import place_params, tp
from repro_torch.dist.sharding import ShardingRules, sharding_context
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention, blocks, layers, model as M, ssm

D = os.environ["CASE_DIR"]
spec = json.load(open(f"{D}/cases.json"))
WIDTHS = []
_dense, _unembed = layers.dense, M.unembed


def dense(params, name, x, compute_dtype=torch.bfloat16):
    y = _dense(params, name, x, compute_dtype)
    WIDTHS.append([name, int(x.shape[-1]), int(y.shape[-1])])
    return y


def unembed(*a, **k):
    y = _unembed(*a, **k)
    WIDTHS.append(["unembed", 0, int(y.shape[-1])])
    return y


for mod in (attention, blocks, ssm, slstm_ops, M):
    mod.dense = dense
M.unembed = unembed


def nest(flat):
    out = {}
    for k, v in flat.items():
        *dirs, last = k.split("/")
        node = out
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = v
    return out


def flat_cache(c, tag):
    return {f"{tag}/{b}/{k}": v.float().numpy()
            for b, leaves in c["blocks"].items() for k, v in leaves.items()}


def run_case(case, c, mesh):
    cfg = dataclasses.replace(ARCHS[c["arch"]].reduced(), **c["over"])
    rules = ShardingRules(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in c["rules"].items()})
    params = nest(dict(np.load(f"{D}/{case}_params.npz")))
    batch = dict(np.load(f"{D}/{case}_batch.npz"))
    toks = np.load(f"{D}/{case}_steps.npy")
    model = lm_params_from_reference(params, cfg, device="cpu")
    out = {}
    del WIDTHS[:]
    with torch.no_grad(), sharding_context(mesh, rules):
        place_params(model, M.param_specs(cfg), mesh, rules)
        lg, aux = M.forward(model, cfg, batch, remat=False)
        out["forward"], out["aux"] = lg.numpy(), aux.numpy()
        pl, cache = M.prefill(model, cfg, batch, c["max_len"])
        out["prefill"] = pl.numpy()
        out.update(flat_cache(cache, "cache_prefill"))
        n = c["n"]
        for i in range(toks.shape[1]):
            lg, cache = M.decode_step(model, cfg, cache, toks[:, i:i + 1],
                                      n + i)
            out[f"decode{i}"] = lg.numpy()
        out.update(flat_cache(cache, "cache_decode"))
        if c.get("fused"):
            read = M._read(model, cfg)
            for i, name in c["fused"]:
                out[f"fused/{i}/{name}"] = read.layers[i]["mixer"][
                    name].numpy()
    np.savez(f"{D}/{case}_r{RANK}.npz", **out)
    return list(WIDTHS)


def vocab_ops(mesh):
    # The vocabulary-parallel gather and cross-entropy against the
    # unsplit ones.
    rules = ShardingRules(batch=("data",), fsdp=(), tp=("model",))
    g = torch.Generator().manual_seed(5)
    V, d = 256, 8
    table = torch.randn((V, d), generator=g)
    ids = torch.tensor([[0, 127, 128, 255, 3, 200],
                        [-1, 256, 300, 129, 126, 64]])
    logits = torch.randn((2, 6, V), generator=g)
    labels = torch.tensor([[0, 127, 128, 255, 5, 250],
                           [126, 129, 1, 254, 128, 127]])
    wts = torch.randn((2, 6), generator=g)
    out = {}
    for impl in ("take", "onehot"):
        want = layers.embed_lookup({"embed": table}, ids, impl,
                                   torch.float32)
        with sharding_context(mesh, rules):
            got = layers.embed_lookup(
                {"embed": table.chunk(2)[RANK]}, ids, impl, torch.float32)
        out[impl] = float((got - want).abs().max())
    full = logits.clone().requires_grad_(True)
    nll = -torch.gather(torch.log_softmax(full, -1), -1,
                        labels[..., None])[..., 0]
    (gfull,) = torch.autograd.grad((nll * wts).sum(), [full])
    block = logits.chunk(2, -1)[RANK].clone().requires_grad_(True)
    with sharding_context(mesh, rules):
        got = tp.vocab_nll(block, labels, tp.split())
    (gblock,) = torch.autograd.grad((got * wts).sum(), [block])
    out["nll"] = float((got - nll).abs().max())
    out["nll_grad"] = float((gblock - gfull.chunk(2, -1)[RANK]).abs().max())
    return out


def replicated(mesh):
    # Shapes tp=2 does not divide run whole (the divisibility guard): the
    # dense calls each config makes, with their widths.
    rules = ShardingRules(batch=("data",), fsdp=(), tp=("model",))
    out = {}
    for arch, over in (("chatglm3-6b", {"vocab": 255}),
                       ("chatglm3-6b", {"d_ff": 127}),
                       ("xlstm-125m", {"n_heads": 1})):
        cfg = dataclasses.replace(ARCHS[arch].reduced(), **over)
        model = M.init_model(cfg, seed=0, device="cpu", mesh=mesh,
                             rules=rules)
        toks = np.zeros((2, 4), dtype=np.int64)
        del WIDTHS[:]
        with torch.no_grad(), sharding_context(mesh, rules):
            lg, _ = M.forward(model, cfg, {"tokens": toks}, remat=False)
        out[json.dumps(over)] = {"widths": list(WIDTHS),
                                 "logits": list(lg.shape)}
    return out


def placed_as_drawn(mesh):
    # init_model(mesh=) against a whole draw placed afterwards.
    rules = ShardingRules(batch=("data",), fsdp=("data",), tp=("model",),
                          ep=("model",))
    cfg = ARCHS["jamba-v0.1-52b"].reduced()
    a = M.init_model(cfg, seed=3, device="cpu", mesh=mesh, rules=rules)
    b = M.init_model(cfg, seed=3, device="cpu")
    place_params(b, M.param_specs(cfg), mesh, rules)
    pairs = list(zip(a.named_parameters(), b.named_parameters()))
    return len(pairs) > 0 and all(
        na == nb and pa.placements == pb.placements
        and torch.equal(pa.to_local(), pb.to_local())
        for (na, pa), (nb, pb) in pairs)


def main():
    mesh = make_local_mesh(*spec["mesh"], device="cpu")
    out = {"widths": {case: run_case(case, c, mesh)
                      for case, c in spec["cases"].items()}}
    if spec.get("units"):
        out["vocab"] = vocab_ops(mesh)
        out["replicated"] = replicated(mesh)
        out["placed_as_drawn"] = placed_as_drawn(mesh)
    return out
"""

TP_RULES = {"batch": ["data"], "fsdp": ["data"], "tp": ["model"]}
FLASH_RULES = {"batch": ["data"], "fsdp": [], "tp": ["model"],
               "sp": ["model"], "flash_decode": True}
# (layer, fused leaf) read on each rank: xlstm's mLSTM and sLSTM, and
# jamba's first Mamba layer.
FUSED = {"xlstm-125m": [[0, "qkv"], [0, "gates"], [1, "zifo"],
                        [1, "r_zifo"]],
         "jamba-v0.1-52b": [[0, "in_proj"]]}


def _ref_case(d, case, over, rules):
    """The reference's outputs on ``case``; writes the rank inputs."""
    arch = _arch(case)
    rcfg = dataclasses.replace(REF_ARCHS[arch].reduced(), **over)
    params, _ = ref_model.init_model(rcfg, jax.random.PRNGKey(0))
    batch = _batch(rcfg)
    np.savez(d / f"{case}_params.npz", **_flat(params))
    np.savez(d / f"{case}_batch.npz", **batch)
    n = S + (N_PATCHES if "patches" in batch else 0)
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (B, 2)).astype(
        np.int32)
    np.save(d / f"{case}_steps.npy", toks)
    want = {}
    want["forward"], want["aux"] = ref_model.forward(params, rcfg, batch,
                                                     remat=False)
    want["prefill"], cache = ref_model.prefill(params, rcfg, batch,
                                               max_len=MAX_LEN)
    want.update(_flat(cache["blocks"], "cache_prefill"))
    for i in range(2):
        want[f"decode{i}"], cache = ref_model.decode_step(
            params, rcfg, cache, toks[:, i:i + 1], jnp.int32(n + i))
    want.update(_flat(cache["blocks"], "cache_decode"))
    spec = {"arch": arch, "over": over, "rules": rules, "max_len": MAX_LEN,
            "n": n, "fused": FUSED.get(case)}
    return {k: np.asarray(v) for k, v in want.items()}, spec, params


def _run(tmp_path_factory, name, mesh, cases, units=False):
    d = tmp_path_factory.mktemp(name)
    want, spec, params = {}, {}, {}
    for case, (over, rules) in cases.items():
        want[case], spec[case], params[case] = _ref_case(d, case, over,
                                                         rules)
    (d / "cases.json").write_text(json.dumps(
        {"mesh": mesh, "cases": spec, "units": units}))
    n = mesh[0] * mesh[1]
    got = run_ranks(_RANKS, n, d, env={"CASE_DIR": str(d)}, timeout=400)
    ranks = {case: [dict(np.load(d / f"{case}_r{r}.npz")) for r in range(n)]
             for case in cases}
    return {"want": want, "ranks": ranks, "got": got, "spec": spec,
            "params": params, "n": n}


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    cases = {c: (over, TP_RULES) for c, over in CASES.items()}
    cases[FLASH] = ({}, FLASH_RULES)
    return _run(tmp_path_factory, "tp2", [1, 2], cases, units=True)


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    return _run(tmp_path_factory, "tp4", [1, 4],
                {"chatglm3-6b": ({}, TP_RULES)})


def _block(cfg, leaf_path: str, v: np.ndarray, r: int, n: int,
           kv_whole: bool) -> np.ndarray:
    """Rank ``r``'s block of a full stacked cache leaf ``(periods, rows,
    ...)``, cut by the split's rules."""
    j, k = leaf_path.split("/")[-2:]
    kind = cfg.block_pattern[int(j[1:])]
    if k in ("k", "v", "k_s", "v_s", "cross_k", "cross_v"):
        if kv_whole:
            return v
        H, KV = cfg.n_heads, cfg.n_kv_heads
        if KV % n == 0:
            return np.split(v, n, axis=3)[r]
        head = r * (H // n) // (H // KV)
        return v[:, :, :, head:head + 1]
    dim = {"conv": 3}.get(k, 2)
    if kind == "attn":
        return v
    return np.split(v, n, axis=dim)[r]


def _close(got, want, what):
    want = np.asarray(want)
    if want.dtype == np.int8:
        np.testing.assert_allclose(got, want, rtol=0, atol=1, err_msg=what)
    else:
        np.testing.assert_allclose(got, want.astype(np.float32),
                                   err_msg=what, **TOL)


def _check_case(run, case):
    spec, want = run["spec"][case], run["want"][case]
    cfg = dataclasses.replace(ARCHS[spec["arch"]].reduced(), **spec["over"])
    kv_whole = bool(spec["rules"].get("flash_decode"))
    for r, got in enumerate(run["ranks"][case]):
        for what in ("forward", "aux", "prefill", "decode0", "decode1"):
            _close(got[what], want[what], f"{case} rank {r} {what}")
        caches = [k for k in want if k.startswith("cache_")]
        assert sorted(caches) == sorted(k for k in got
                                        if k.startswith("cache_"))
        for k in caches:
            w = want[k]
            if not kv_whole or k.split("/")[-1] not in ("k", "v"):
                w = _block(cfg, k, w, r, run["n"], kv_whole)
            elif kv_whole:      # flash-decoding: this rank's positions
                w = np.split(w, run["n"], axis=2)[r]
            assert got[k].shape == w.shape, (case, r, k)
            _close(got[k], w, f"{case} rank {r} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_architecture_matches_the_reference_under_tp(tp2, case):
    _check_case(tp2, case)


def test_kv_heads_under_tp4_follow_the_query_heads(tp4):
    """tp = 4 over 2 KV heads: each rank's cache holds one KV head, the
    one its query head reads, and the logits hold the reference's."""
    _check_case(tp4, "chatglm3-6b")
    shapes = {r: got["cache_prefill/b0/k"].shape
              for r, got in enumerate(tp4["ranks"]["chatglm3-6b"])}
    assert all(s[3] == 1 for s in shapes.values()), shapes
    widths = {tuple(w) for w in tp4["got"]["widths"]["chatglm3-6b"]}
    hd = ARCHS["chatglm3-6b"].reduced().hd
    assert ("wq", 64, hd) in widths and ("wk", 64, hd) in widths


def test_flash_decoding_beside_tp_matches_the_plain_decode(tp2):
    """tp=sp=("model",) with flash-decoding: the attention keeps its
    heads whole and each rank its positions of the cache; the MLP is
    split."""
    _check_case(tp2, FLASH)
    cfg = ARCHS["chatglm3-6b"].reduced()
    widths = {tuple(w) for w in tp2["got"]["widths"][FLASH]}
    assert ("wq", cfg.d_model, cfg.n_heads * cfg.hd) in widths
    assert ("wo", cfg.n_heads * cfg.hd, cfg.d_model) in widths
    assert ("w_gate", cfg.d_model, cfg.d_ff // 2) in widths
    assert ("w_down", cfg.d_ff // 2, cfg.d_model) in widths


# Each tp projection's (split side, full width) of a reduced config.
def _split_widths(cfg) -> dict:
    di, hd = cfg.d_inner, cfg.hd
    return {"wq": ("out", cfg.n_heads * hd),
            "wk": ("out", cfg.n_kv_heads * hd),
            "wv": ("out", cfg.n_kv_heads * hd),
            "wo": ("in", cfg.n_heads * hd), "w_gate": ("out", cfg.d_ff),
            "w_up": ("out", cfg.d_ff), "w_in": ("out", cfg.d_ff),
            "w_down": ("in", cfg.d_ff), "in_proj": ("out", 2 * di),
            "x_proj": ("in", di), "out_proj": ("in", di),
            "qkv": ("out", 3 * di), "gates": ("out", 2 * cfg.n_heads),
            "up": ("out", di), "zifo": ("out", 4 * di),
            "unembed": ("out", cfg.vocab), "frontend": ("whole", None)}


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_every_tp_projection_runs_at_a_split_width(tp2, case):
    cfg = ARCHS[case].reduced()
    want = _split_widths(cfg)
    seen = set()
    for name, w_in, w_out in tp2["got"]["widths"][case]:
        side, full = want[name]
        seen.add(name)
        if side == "whole":
            continue
        got = w_in if side == "in" else w_out
        assert got * 2 == full, (name, w_in, w_out, full)
    assert "unembed" in seen and len(seen) > 2, seen


def test_fused_cuts_are_each_parts_block(tp2):
    """Each rank's ``qkv``, ``gates``, ``zifo`` and ``in_proj`` are the
    concatenation of its block of each part of the reference's matrix
    (the first trap: a contiguous block would hand rank 0 all of z and i
    and nothing of f and o)."""
    for case, leaves in FUSED.items():
        cfg = ARCHS[case].reduced()
        params = tp2["params"][case]
        for r, got in enumerate(tp2["ranks"][case]):
            for i, name in leaves:
                j, p = i % cfg.period, i // cfg.period
                ref = np.asarray(params["blocks"][f"b{j}"]["mixer"][name][p])
                parts = FUSED_PARTS.get(name, 1)
                dim = ref.ndim - 1
                blocks = [np.split(part, 2, axis=dim)[r]
                          for part in np.split(ref, parts, axis=dim)]
                np.testing.assert_array_equal(
                    got[f"fused/{i}/{name}"], np.concatenate(blocks, dim),
                    err_msg=f"{case} {name} rank {r}")
                if parts > 1:
                    contiguous = np.split(ref, 2, axis=dim)[r]
                    assert not np.array_equal(got[f"fused/{i}/{name}"],
                                              contiguous)


FUSED_PARTS = {"qkv": 3, "gates": 2, "zifo": 4, "in_proj": 2}


def test_vocab_parallel_gather_and_cross_entropy(tp2):
    v = tp2["got"]["vocab"]
    assert v["take"] == 0.0 and v["onehot"] == 0.0, v
    assert v["nll"] <= 1e-5 and v["nll_grad"] <= 1e-6, v


def test_init_model_places_each_parameter_as_drawn(tp2):
    """``init_model(mesh=, rules=)`` holds the blocks and placements of a
    whole draw placed by ``place_params``."""
    assert tp2["got"]["placed_as_drawn"] is True


def test_indivisible_splits_raise_naming_the_leaf(tp2):
    """They no longer raise: a vocabulary, an FFN width and mLSTM heads
    that tp = 2 does not divide run whole on each rank, at their full
    widths in the ``dense`` log, while what divides stays split (their
    values against the reference: ``tests/test_torch_lm_replicate.py``)."""
    got = tp2["got"]["replicated"]
    cfg = ARCHS["chatglm3-6b"].reduced()
    xl = ARCHS["xlstm-125m"].reduced()

    def widths(over):
        run = got[json.dumps(over)]
        return run["logits"], {(n, i, o) for n, i, o in run["widths"]}

    logits, seen = widths({"vocab": 255})
    assert logits[-1] == 255 and ("unembed", 0, 255) in seen
    assert ("w_gate", cfg.d_model, cfg.d_ff // 2) in seen
    logits, seen = widths({"d_ff": 127})
    assert ("w_gate", cfg.d_model, 127) in seen
    assert ("w_down", 127, cfg.d_model) in seen
    assert ("unembed", 0, cfg.vocab // 2) in seen
    logits, seen = widths({"n_heads": 1})
    assert ("gates", xl.d_model, 2) in seen
    assert ("qkv", xl.d_model, 3 * xl.d_inner) in seen
    assert ("out_proj", xl.d_inner, xl.d_model) in seen
    assert ("zifo", xl.d_model, 4 * xl.d_inner // 2) in seen


def test_launcher_reports_what_tp_and_sp_act_split():
    """``launch/train.py``'s ``logical axes realised`` line on the
    production mesh's shape: ``tp`` splits the compute; ``sp_act`` the
    stream where it lies on ``tp``'s mesh dimensions, else not."""
    import types

    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch.train import realised

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(16, 16), size=lambda i: 16)
    line = realised(mesh, ShardingRules(batch=("pod", "data"),
                                        fsdp=("data",)))
    assert "tp->model (split: heads, channels, FFN columns, " \
        "vocabulary)" in line
    assert "sp_act" not in line and "whole" not in line
    on_tp = realised(mesh, ShardingRules(sp_act=("model",)))
    assert "sp_act->model (split: the stream along the sequence)" in on_tp
    off_tp = realised(mesh, ShardingRules(sp_act=("data",)))
    assert "sp_act->data (stream whole: not on tp's mesh dimensions)" \
        in off_tp
