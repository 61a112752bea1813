"""Read a cell's control on the card, seed by seed.

    python3 bench/control.py --workload <name> --seeds <n> [<n> ...] --seconds <s>

The control is the configuration's comparison fed one precision lower
(``bench/limits/<config>.json`` names it: the program's own bfloat16
wire for float32, the reference's 4-bit codes for int8).  Each seed
prints one JSON line with the numbers compared and ``correct``, which
has to read false.  The benchmark's own runs never run it; the limits
were set between its readings and the program's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch

    from bench.harness import control, registry

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark()
    for seed in args.seeds:
        checks, ok = control.run(bench, args.workload, seed, args.seconds,
                                 torch.device("cuda", 0), T_START)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": ok, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
