"""Run one script in several gloo ranks on the CPU; return rank 0's JSON.

Each rank is its own Python process (``RANK``, ``WORLD_SIZE``) joined
through a ``FileStore`` under the test's temporary directory, so
parallel test workers never share a rendezvous.  The script defines
``main()``, which every rank runs between the process group's creation
and destruction; rank 0 prints what it returns as JSON.  A rank that
fails ends the run: the others are killed, and its standard error is in
the assertion message.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PRELUDE = """
import datetime, json, os, sys
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])
WORLD = int(os.environ["WORLD_SIZE"])
dist.init_process_group(
    "gloo", store=dist.FileStore({store!r}, WORLD), rank=RANK,
    world_size=WORLD, timeout=datetime.timedelta(seconds={timeout}))
"""

_EPILOGUE = """
try:
    _out = main()
finally:
    dist.destroy_process_group()
if RANK == 0:
    print(json.dumps(_out))
"""


def run_ranks(body: str, n: int, tmp_path, timeout: float = 240.0,
              env: dict | None = None):
    """Run ``body`` (defining ``main()``) in ``n`` ranks, with ``env``
    added to the environment; rank 0's result."""
    tmp = pathlib.Path(tmp_path)
    script = tmp / "ranks.py"
    script.write_text(
        _PRELUDE.format(src=str(SRC), store=str(tmp / "store"),
                        timeout=int(timeout))
        + textwrap.dedent(body) + _EPILOGUE)
    env = dict(os.environ, **(env or {}), WORLD_SIZE=str(n))
    env.pop("XLA_FLAGS", None)
    logs = [(tmp / f"rank{r}.out", tmp / f"rank{r}.err") for r in range(n)]
    procs = []
    for r, (out, err) in enumerate(logs):
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen(
                [sys.executable, str(script)], env=dict(env, RANK=str(r)),
                stdout=fo, stderr=fe))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in
                   (None, 0)]
            if bad or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    # The ranks that failed by themselves first, then those killed here.
    failed = sorted((r for r, p in enumerate(procs) if p.returncode),
                    key=lambda r: procs[r].returncode < 0)
    assert not failed, "\n".join(
        f"rank {r} exited {procs[r].returncode}:\n"
        f"{logs[r][1].read_text()[-3000:]}" for r in failed[:2])
    return json.loads(logs[0][0].read_text().strip().splitlines()[-1])
