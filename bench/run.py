"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards.
The cell, its configuration, traffic mix, metrics and limits are found
by name from ``BENCHMARK.json``.  The run makes its inputs from the
seed, builds the program (``repro_torch``) as the configuration states,
warms it up, measures for ``--seconds``, checks every volume it served
against the plain reference in ``bench/reference/``, and prints one JSON
object as the last line of standard output (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer metrics, from the
profiler's trace).  It exits with another code than 0 and prints no
result where there is no card, too few cards, a part it cannot find,
or, once the window has closed, a JAX module or the JAX package loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# Top-level module names that may not be loaded when the run ends.
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def query_card():
    """Start ``nvidia-smi`` for the card's name and power limit; the
    answer is read with :func:`card_line`.  It runs once the cell's run
    is over, not beside the set-up, whose time it would take."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def card_line(proc) -> str:
    if proc is None:
        return "nvidia-smi unavailable"
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return "nvidia-smi did not answer"
    lines = out.strip().splitlines()
    return lines[0] if lines else "nvidia-smi gave nothing"


def finite(x):
    """``x`` with every non-finite float replaced by None (valid JSON)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def result_line(out: dict) -> str:
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    return json.dumps({k: finite(out[k]) for k in keys if k in out})


def log_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    return run(args)


def run(args) -> int:
    import torch

    from bench.harness import cell, registry

    t_import = time.perf_counter() - T_START
    bench = registry.benchmark()
    chips = registry.cell(bench, args.workload)["chips"]

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"imports {t_import:.3f} s", file=sys.stderr, flush=True)
    torch.set_num_threads(4)
    out = cell.run(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), T_START)
    print(f"card: {card_line(query_card())}", file=sys.stderr, flush=True)
    bad = banned_modules()
    if bad:
        print(f"modules that may not be loaded: {bad}", file=sys.stderr)
        return 3
    log_checks(out["checks"])
    print(result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
