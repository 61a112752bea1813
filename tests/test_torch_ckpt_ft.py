"""Mirrors of ``tests/test_optim_ckpt_ft.py``'s checkpoint and
fault-tolerance tests for the port (``repro_torch.ckpt``,
``repro_torch.ft``), with bfloat16 and int8 leaves, an ``nn.Module`` in
the tree, and the on-disk layout the reference reads: a checkpoint the
port writes loads in the reference's ``load_checkpoint`` bit for bit.
"""

import os
import time
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import load_checkpoint as ref_load
from repro_torch.ckpt import (CheckpointManager, all_steps, load_checkpoint,
                              save_checkpoint)
from repro_torch.ft.manager import (FaultTolerantLoop, Preempted,
                                    PreemptionSimulator, run_with_restarts)
from repro_torch.models.layers import Params
from repro_torch.training.optim import (AdamWConfig, adamw_update,
                                        init_opt_state)


def _tree():
    return {"a": torch.arange(6).reshape(2, 3).to(torch.bfloat16),
            "nested": {"b": torch.ones((4,), dtype=torch.int8),
                       "q": torch.tensor([-127, 3, 127], dtype=torch.int8)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = _tree()
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, tree)
    save_checkpoint(d, 7, {"a": tree["a"] * 0,
                           "nested": {k: v * 0 for k, v in
                                      tree["nested"].items()},
                           "step": tree["step"] * 0})
    like = {"a": torch.zeros(2, 3, dtype=torch.bfloat16),
            "nested": {"b": torch.zeros(4, dtype=torch.int8),
                       "q": torch.zeros(3, dtype=torch.int8)},
            "step": torch.tensor(0, dtype=torch.int32)}
    out, step = load_checkpoint(d, like)
    assert step == 7
    assert float(out["a"].float().abs().sum()) == 0.0
    out3, _ = load_checkpoint(d, like, step=3)
    for got, want in ((out3["a"], tree["a"]), (out3["nested"]["q"],
                                               tree["nested"]["q"]),
                      (out3["step"], tree["step"])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # Each leaf lands on the device named, else on the template's.
    on_host, _ = load_checkpoint(d, like, step=3, device="cpu")
    assert all(t.device.type == "cpu" for t in (on_host["a"],
                                                on_host["step"]))
    # The template is left as it was; no .tmp dirs linger.
    assert not like["a"].any()
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]


def test_checkpoint_is_the_reference_layout(tmp_path):
    """The reference's ``load_checkpoint`` reads the port's files: the
    same leaves, dtypes and bits (bfloat16 and int8 included)."""
    tree = _tree()
    d = str(tmp_path / "ck")
    save_checkpoint(d, 5, tree)
    like = {"a": jnp.zeros((2, 3), jnp.bfloat16),
            "nested": {"b": jnp.zeros(4, jnp.int8),
                       "q": jnp.zeros(3, jnp.int8)},
            "step": jnp.int32(0)}
    out, step = ref_load(d, like)
    assert step == 5
    np.testing.assert_array_equal(np.asarray(out["a"], np.float32),
                                  tree["a"].float().numpy())
    np.testing.assert_array_equal(np.asarray(out["nested"]["q"]),
                                  tree["nested"]["q"].numpy())
    assert int(out["step"]) == 7


def test_a_module_restores_in_place(tmp_path):
    model = Params(torch.bfloat16, torch.device("cpu"),
                   torch.Generator().manual_seed(0))
    model.add("w", (3, 4))
    model.sub("blk").add("s", (4,), init="ones")
    opt = init_opt_state(model, AdamWConfig(state_dtype="int8"))
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, {"params": model, "opt": opt})
    fresh = Params(torch.bfloat16, torch.device("cpu"), None)
    fresh.add("w", (3, 4), init="zeros")
    fresh.sub("blk").add("s", (4,), init="zeros")
    out, _ = load_checkpoint(d, {"params": fresh, "opt": init_opt_state(
        fresh, AdamWConfig(state_dtype="int8"))})
    assert out["params"] is fresh
    assert torch.equal(fresh.w, model.w) and torch.equal(fresh.blk.s,
                                                         model.blk.s)
    assert torch.equal(out["opt"]["m"]["w"]["s"], opt["m"]["w"]["s"])


def test_in_place_restore_fills_the_template(tmp_path):
    """``in_place``: every leaf of the template receives its values and
    is the leaf returned; a leaf of another dtype, or a device named
    beside ``in_place``, is refused."""
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, _tree())
    like = {"a": torch.zeros(2, 3, dtype=torch.bfloat16),
            "nested": {"b": torch.zeros(4, dtype=torch.int8),
                       "q": torch.zeros(3, dtype=torch.int8)},
            "step": torch.tensor(0, dtype=torch.int32)}
    out, step = load_checkpoint(d, like, in_place=True)
    assert step == 3
    assert out["a"] is like["a"] and out["nested"]["q"] is like["nested"]["q"]
    assert torch.equal(like["a"], _tree()["a"])
    assert torch.equal(like["nested"]["q"], _tree()["nested"]["q"])
    assert int(like["step"]) == 7
    with pytest.raises(ValueError, match="template"):
        load_checkpoint(d, dict(like, a=torch.zeros(2, 3)), in_place=True)
    with pytest.raises(ValueError, match="in_place"):
        load_checkpoint(d, like, in_place=True, device="cpu")


def test_restart_holds_one_copy_of_the_state(tmp_path):
    """A restart drops the preempted state before ``init_fn`` builds the
    restore template, and the checkpoint loads into that template: the
    resumed state is the template's tensor, and no earlier state is
    alive while a template is made."""
    made = []

    def init_fn():
        assert all(r() is None for r in made), "an earlier state is alive"
        x = torch.zeros(3)
        made.append(weakref.ref(x))
        return {"x": x}

    def step_fn(state, step):
        state["x"].add_(1.0)
        return state, {}

    fired = set()

    def health(step):
        if step in (4, 7) and step not in fired:
            fired.add(step)
            return True
        return False

    state, step, restarts = run_with_restarts(
        lambda: FaultTolerantLoop(str(tmp_path / "ck"), save_every=2,
                                  health=health),
        init_fn, step_fn, 10)
    assert (step, restarts, len(made)) == (10, 2, 3)
    assert made[-1]() is state["x"]
    assert torch.equal(state["x"], torch.full((3,), 10.0))


def test_checkpoint_refuses_another_structure(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 0, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(d, {"x": torch.zeros(2), "y": torch.zeros(1)})
    with pytest.raises(ValueError, match="template"):
        load_checkpoint(d, {"z": torch.zeros(2)})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), {"x": torch.zeros(2)})


def test_checkpoint_retention(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"x": torch.zeros((2,))}
    for s in range(6):
        save_checkpoint(d, s, tree, keep=2)
    assert all_steps(d) == [4, 5]


def test_async_manager(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    tree = {"x": torch.arange(4.0), "h": torch.arange(4.0).bfloat16()}
    mgr.save_async(1, tree)
    mgr.save_async(2, {k: v + 1 for k, v in tree.items()})
    tree["x"] += 100                 # the snapshot was taken at the call
    mgr.wait()
    assert mgr.latest_step() == 2
    out, step = mgr.restore({"x": torch.zeros(4),
                             "h": torch.zeros(4, dtype=torch.bfloat16)})
    assert step == 2
    np.testing.assert_allclose(out["x"].numpy(), np.arange(4.0) + 1)
    assert out["h"].dtype == torch.bfloat16


def test_async_manager_reraises_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker / "ck"))
    mgr.save_async(1, {"x": torch.zeros(1)})
    with pytest.raises(OSError):
        mgr.wait()


# ----------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_preemption_resume_bit_exact(tmp_path, state_dtype):
    """Training interrupted by preemption resumes to the same bits."""
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                      state_dtype=state_dtype)

    def init_fn():
        params = {"w": torch.tensor([[2.0, -3.0, 1.0]]).to(torch.bfloat16)}
        return {"params": params, "opt": init_opt_state(params, cfg)}

    def step_fn(state, step):
        grads = {"w": 2 * state["params"]["w"] + 0.01 * step}
        p, o, stats = adamw_update(grads, state["params"], state["opt"],
                                   cfg)
        return {"params": p, "opt": o}, stats

    n_steps = 30
    ref = init_fn()
    for s in range(n_steps):
        ref, _ = step_fn(ref, s)

    sim = PreemptionSimulator({11, 23})
    fired = set()

    def health(step):
        if step in sim.at_steps and step not in fired:
            fired.add(step)
            return True
        return False

    def make_loop():
        return FaultTolerantLoop(str(tmp_path / "ck"), save_every=5,
                                 health=health)

    state, step, restarts = run_with_restarts(make_loop, init_fn, step_fn,
                                              n_steps)
    assert restarts == 2
    assert step == n_steps
    assert torch.equal(state["params"]["w"], ref["params"]["w"])
    assert int(state["opt"]["step"]) == n_steps


def test_preempted_loop_checkpoints_on_the_way_down(tmp_path):
    loop = FaultTolerantLoop(str(tmp_path / "ck"), save_every=0,
                             health=PreemptionSimulator({4}))
    with pytest.raises(Preempted):
        loop.run({"x": torch.zeros(1)}, 0, 10,
                 lambda s, i: ({"x": s["x"] + 1}, {}))
    assert loop.mgr.latest_step() == 3
    state, start = loop.restore_or_init(lambda: {"x": torch.zeros(1)})
    assert start == 4 and float(state["x"]) == 4.0


def test_straggler_detection(tmp_path):
    loop = FaultTolerantLoop(str(tmp_path / "unused_ck_dir"), save_every=0)

    def step_fn(state, step):
        time.sleep(0.25 if step == 12 else 0.005)
        return state, {}

    loop.run({}, 0, 20, step_fn)
    assert 12 in loop.stragglers
