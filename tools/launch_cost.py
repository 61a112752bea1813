"""Host microseconds a launch of rows 9 and 10 through the launchers of
the tree on PYTHONPATH (run once per tree, in turns): the call returns
once the kernel is enqueued, so back-to-back calls time the host.

    PYTHONPATH=<tree>/src python3 tools/launch_cost.py <label>

Run parent, change, change, parent in one call on the card (an older
checkout unpacked with ``git archive``) to compare two trees.
"""
import sys, time, json
import torch
from repro_torch.kernels.gather import launch_onehot_gather
from repro_torch.kernels.slstm import launch_slstm

dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
table = torch.randn(50304, 768, generator=g, device=dev).to(torch.bfloat16)
ids = torch.randint(0, 50304, (4,), generator=g, device=dev)
zifo = torch.randn(4, 1, 4, 1536, generator=g, device=dev)
r = torch.randn(4, 1536, generator=g, device=dev)
state = torch.zeros(4, 4, 1536, device=dev)
out = {}
for name, f in (("row9 bf16 N=4", lambda: launch_onehot_gather(table, ids)),
                ("row10 (4, 1)", lambda: launch_slstm(zifo, r, state))):
    for _ in range(500):
        f()
    torch.cuda.synchronize()
    ts = []
    for _ in range(7):
        t = time.perf_counter()
        for _ in range(2000):
            f()
        ts.append((time.perf_counter() - t) / 2000 * 1e6)
        torch.cuda.synchronize()
    out[name] = sorted(ts)[3]
print(json.dumps({"tree": sys.argv[1], "host_us_a_launch": out}))
