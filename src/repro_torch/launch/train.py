"""Training launcher, counterpart of ``repro/launch/train.py``: the
fault-tolerant loop over the train step under a device mesh, with the
reference's flags and defaults (``--arch chatglm3-6b``, 100 steps of 8 x
64 tokens, ``--reduced`` with a vocabulary of 256), plus ``--device``
(the card by default):

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
        --reduced --steps 50 --ckpt /tmp/repro_run --device cpu

As the reference's, it trains under ``make_local_mesh()`` (every rank
of the world on the ``data`` axis), or ``make_production_mesh()`` with
``--production-mesh``, with ``ShardingRules(batch=("pod", "data"),
fsdp=("data",))``: each parameter placed by its logical axes as it is
drawn (``init_model(mesh=, rules=)``), the batch split over ``data``.
A world of one is a 1x1 mesh (NCCL on the card, gloo on the CPU),
which runs the one-device step exactly; a larger world comes from the
environment
(:func:`repro_torch.launch.mesh.init_world`: ``torchrun``'s variables,
or ``REPRO_TORCH_INIT_METHOD``, e.g. ``file:///path``).

Rank 0 prints ``arch=... (...M params) mesh={...}``, the logical axes
the mesh realises, the loss every 10 steps and ``finished at step N (R
restarts)``, as the reference's, then the steps' wall time, the AdamW
update's share of it, the last step's loss, the collectives a step and,
on the card, the peak of allocated memory, and last every step's loss
in full (``losses {"step": loss, ...}``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import torch
import torch.distributed as dist

from ..configs import ARCHS
from ..data.tokens import TokenDataset
from ..dist import fsdp
from ..dist.sharding import (ShardingRules, logical_to_spec,
                             sharding_context)
from ..ft.manager import FaultTolerantLoop, run_with_restarts
from ..models.model import init_model
from ..training import AdamWConfig, init_opt_state, make_train_step
from .mesh import init_world, make_local_mesh, make_production_mesh


def realised(mesh, rules) -> str:
    """Which logical axes the mesh splits: ``tp`` splits the heads,
    channels, FFN columns and vocabulary, ``sp_act`` the residual stream
    along the sequence where it lies on ``tp``'s mesh dimensions (else
    the stream stays whole; :mod:`repro_torch.dist.tp`)."""
    out = []
    for ax in ("batch", "fsdp", "tp", "ep", "sp", "sp_act"):
        spec = logical_to_spec((ax,), rules, mesh)[0]
        axes = () if spec is None else (
            spec if isinstance(spec, tuple) else (spec,))
        dims = fsdp.axis_dims(mesh, axes)
        if not dims:
            continue
        note = "split"
        if ax == "tp":
            note = "split: heads, channels, FFN columns, vocabulary"
        elif ax == "sp_act":
            note = ("split: the stream along the sequence"
                    if dims == fsdp.axis_dims(mesh, rules.tp)
                    else "stream whole: not on tp's mesh dimensions")
        out.append(f"{ax}->{'x'.join(axes)} ({note})")
    return ", ".join(out) or "none (one rank)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config (otherwise the full config "
                         "— wants real hardware)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="/tmp/repro_train")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--moe-impl", default="scatter")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = init_world(args.device)
    try:
        mesh = (make_production_mesh(device=dev) if args.production_mesh
                else make_local_mesh(device=dev))
    except ValueError as e:
        ap.exit(2, f"--production-mesh: {e}\n")
    try:
        return _train(args, dev, mesh)
    finally:
        dist.destroy_process_group()


def _train(args, dev, mesh):
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), vocab=256)
    rules = ShardingRules(batch=("pod", "data"), fsdp=("data",))
    lead = dist.get_rank() == 0
    shape = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    if lead:
        print(f"arch={cfg.name} ({cfg.param_count() / 1e6:.1f}M params) "
              f"mesh={shape} device={dev}", flush=True)
        print(f"logical axes realised: {realised(mesh, rules)}", flush=True)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    ds = TokenDataset(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, device=str(dev))
    update_s = []
    step_fn = make_train_step(cfg, opt_cfg, moe_impl=args.moe_impl,
                              remat=True, accum_steps=args.accum_steps,
                              update_times=update_s)
    collectives = []

    def init_fn():
        # Each parameter is placed as it is drawn: a rank never holds the
        # whole model.
        params = init_model(cfg, seed=0, device=dev, mesh=mesh,
                            rules=rules).requires_grad_(True)
        return {"params": params, "opt": init_opt_state(params, opt_cfg)}

    def train_one(state, step):
        before = sum(fsdp.COUNTS.values())
        p, o, metrics = step_fn(state["params"], state["opt"],
                                ds.batch(step))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)     # the loop times whole steps
        collectives.append(sum(fsdp.COUNTS.values()) - before)
        return {"params": p, "opt": o}, metrics

    loops = []

    def make_loop():
        loops.append(FaultTolerantLoop(args.ckpt,
                                       save_every=args.save_every))
        return loops[-1]

    last, losses = {}, {}

    def logged(state, i):
        state, metrics = _logged(train_one, state, i, lead)
        last.update(step=i, loss=float(metrics["loss"]))
        losses[i] = last["loss"]
        return state, metrics

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with sharding_context(mesh, rules):
        _, step, restarts = run_with_restarts(make_loop, init_fn, logged,
                                              args.steps)
    times = [t for loop in loops for t in loop.step_times]
    if not lead:
        return step, restarts
    print(f"finished at step {step} ({restarts} restarts)")
    if times:
        tokens = args.batch * args.seq
        med = statistics.median(times)
        peak = (f"; peak allocated "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
                if dev.type == "cuda" else "")
        print(f"{len(times)} steps on {dev}: median {med:.4f} s a step "
              f"(first {times[0]:.4f} s; the update median "
              f"{statistics.median(update_s):.4f} s), {tokens / med:.1f} "
              f"tokens/s; loss {last['loss']:.4f} at step "
              f"{last['step']}{peak}; {statistics.median(collectives):g} "
              f"collectives a step", flush=True)
        print(f"losses {json.dumps({str(k): v for k, v in sorted(losses.items())})}",
              flush=True)
    return step, restarts


def _logged(fn, state, i, lead=True):
    state, metrics = fn(state, i)
    if lead and i % 10 == 0:
        print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
              f"gnorm={float(metrics['grad_norm']):.2f}", flush=True)
    return state, metrics


if __name__ == "__main__":
    main()
