"""ms per decode call (host wall, synchronised) of xlstm-125m and
chatglm3-6b at full width, bf16, gather_impl="onehot", 4 slots, through
the tree on PYTHONPATH; run once per tree, in turns.

    PYTHONPATH=<tree>/src python3 tools/decode_cost.py <label>

Run parent, change, change, parent in one call on the card to compare
two trees.
"""
import dataclasses, json, statistics, sys, time
import torch
from repro_torch.configs import ARCHS
from repro_torch.models import decode_step, init_cache, init_model

dev = torch.device("cuda", 0)
out = {}
for name in ("xlstm-125m", "chatglm3-6b"):
    cfg = dataclasses.replace(ARCHS[name], gather_impl="onehot")
    model = init_model(cfg, seed=0, device=dev)
    cache = init_cache(cfg, 4, 1024, device=dev)
    toks = torch.zeros((4, 1), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for _ in range(10):
            decode_step(model, cfg, cache, toks, 512)
        torch.cuda.synchronize()
        ts = []
        for _ in range(7):
            t = time.perf_counter()
            for _ in range(20):
                decode_step(model, cfg, cache, toks, 512)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) / 20 * 1e3)
    out[name] = {"median_ms": statistics.median(ts), "min_ms": min(ts),
                 "max_ms": max(ts)}
    del model, cache
    torch.cuda.empty_cache()
print(json.dumps({"tree": sys.argv[1], "decode_ms": out}))
