"""Serving launcher: the continuous-batching engine over synthetic
traffic, counterpart of ``repro/launch/serve.py``: the same flags with
the same defaults (``--arch chatglm3-6b``) and the same reduced config,
plus ``--device`` (the card by default):

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --slots 4

Every architecture serves at its ``reduced()`` widths, jamba-v0.1-52b
(Mamba and MoE), qwen3-moe-235b-a22b and kimi-k2-1t-a32b (MoE) among
them, but for the encoder-decoder (whisper-small), which needs audio
frames the launcher does not make.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS
from ..models.model import init_model
from ..serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch].reduced()
    params = init_model(cfg, seed=0, device=args.device)
    eng = ServingEngine(cfg, params, n_slots=args.slots,
                        max_len=args.max_len, device=args.device)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        r = Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, 4 + (i % 7) * 3),
                    max_tokens=args.max_tokens,
                    temperature=0.8 if i % 2 else 0.0)
        reqs.append(r)
        eng.submit(r)
    t0 = time.time()
    ticks = eng.run_until_done()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    n = sum(len(r.out_tokens) for r in reqs)
    print(f"{len(reqs)} reqs x {args.slots} slots: {ticks} ticks, "
          f"{n} tokens, {n / dt:.1f} tok/s on {eng.device}")
    return reqs


if __name__ == "__main__":
    main()
