"""Training launcher, counterpart of ``repro/launch/train.py``: the
fault-tolerant loop over the train step on one device, with the
reference's flags and defaults (``--arch chatglm3-6b``, 100 steps of 8 x
64 tokens, ``--reduced`` with a vocabulary of 256), plus ``--device``
(the card by default):

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
        --reduced --steps 50 --ckpt /tmp/repro_run --device cpu

It prints ``arch=... (...M params)``, the loss every 10 steps and
``finished at step N (R restarts)``, as the reference's, then the steps'
wall time, the AdamW update's share of it, the last step's loss and, on
the card, the peak of allocated memory.  The reference's ``--production-mesh`` trains over a device mesh, which the
port does not yet (ROADMAP item 8b): the flag exits with a message.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics

import torch

from .._device import resolve_device
from ..configs import ARCHS
from ..data.tokens import TokenDataset
from ..ft.manager import FaultTolerantLoop, run_with_restarts
from ..models.model import init_model
from ..training import AdamWConfig, init_opt_state, make_train_step


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
    ap.add_argument("--production-mesh", action="store_true",
                    help="not in the port yet (ROADMAP item 8b)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.production_mesh:
        ap.exit(2, "--production-mesh: the port trains on one device; the "
                   "LM stack under a mesh is ROADMAP item 8b\n")
    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), vocab=256)
    print(f"arch={cfg.name} ({cfg.param_count() / 1e6:.1f}M params) "
          f"device={dev}", flush=True)

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps)
    ds = TokenDataset(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, device=str(dev))
    update_s = []
    step_fn = make_train_step(cfg, opt_cfg, moe_impl=args.moe_impl,
                              remat=True, accum_steps=args.accum_steps,
                              update_times=update_s)

    def init_fn():
        params = init_model(cfg, seed=0, device=dev).requires_grad_(True)
        return {"params": params, "opt": init_opt_state(params, opt_cfg)}

    def train_one(state, step):
        p, o, metrics = step_fn(state["params"], state["opt"],
                                ds.batch(step))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)     # the loop times whole steps
        return {"params": p, "opt": o}, metrics

    loops = []

    def make_loop():
        loops.append(FaultTolerantLoop(args.ckpt,
                                       save_every=args.save_every))
        return loops[-1]

    last = {}

    def logged(state, i):
        state, metrics = _logged(train_one, state, i)
        last.update(step=i, loss=float(metrics["loss"]))
        return state, metrics

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _, step, restarts = run_with_restarts(make_loop, init_fn, logged,
                                          args.steps)
    print(f"finished at step {step} ({restarts} restarts)")
    times = [t for loop in loops for t in loop.step_times]
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
              f"{last['step']}{peak}", flush=True)
    return step, restarts


def _logged(fn, state, i):
    state, metrics = fn(state, i)
    if i % 10 == 0:
        print(f"step {i:4d} loss={float(metrics['loss']):.4f} "
              f"gnorm={float(metrics['grad_norm']):.2f}", flush=True)
    return state, metrics


if __name__ == "__main__":
    main()
