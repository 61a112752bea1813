"""Find the benchmark's parts by the names ``BENCHMARK.json`` gives.

Every configuration, traffic mix, metric, kernel family and limit sits
in a file of its own under ``bench/``; a name that has no file fails
here, loudly, before anything runs.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


class NotFound(LookupError):
    """A name in ``BENCHMARK.json`` or a cell that has no file."""


def _read_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise NotFound(f"{path.relative_to(ROOT)} does not exist")
    with path.open() as f:
        return json.load(f)


def benchmark(path: pathlib.Path | None = None) -> dict:
    return _read_json(path or ROOT / "BENCHMARK.json")


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    known = ", ".join(e["name"] for e in entries)
    raise NotFound(f"no {what} named {name!r} in BENCHMARK.json "
                   f"(known: {known})")


def cell(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str) -> dict:
    entry = _by_name(bench["configs"], name, "configuration")
    return _read_json(ROOT / entry["file"])


# The keys of a traffic mix that the harness reads (``about`` is prose).
# The clients run a closed loop, or are paced at ``fps`` frames a second.
TRAFFIC_KEYS = frozenset({"clients", "tenants", "chunk", "scans", "views",
                          "fps", "about"})


def traffic(name: str) -> dict:
    """The mix ``bench/traffic/<name>.json``; a key that no code here
    reads fails, rather than being run as something else."""
    mix = _read_json(BENCH / "traffic" / f"{name}.json")
    unread = sorted(set(mix) - TRAFFIC_KEYS)
    if unread:
        raise ValueError(f"bench/traffic/{name}.json: the harness reads no "
                         f"{unread} (it reads {sorted(TRAFFIC_KEYS)})")
    return mix


def limits(config_name: str) -> dict:
    return _read_json(BENCH / "limits" / f"{config_name}.json")


def metrics(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``kind`` (``end_to_end`` or ``per_layer``) metrics that
    ``cell_name`` reports: those without ``workloads`` and those whose
    ``workloads`` list it."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """The module ``bench/metrics/<name>.py``; its ``read(ctx)`` returns
    the metric's value, or ``None`` where it finds nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        raise NotFound(f"no reader for metric {name!r}: "
                       f"{path.relative_to(ROOT)} does not exist")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise NotFound(f"{path.relative_to(ROOT)} defines no read(ctx)")
    return module


def families() -> dict[str, list[str]]:
    """``{layer: [kernel name fragments]}`` from every
    ``bench/layers/*.json``; files naming one layer add up."""
    out: dict[str, list[str]] = {}
    for path in sorted((BENCH / "layers").glob("*.json")):
        fam = _read_json(path)
        out.setdefault(fam["layer"], []).extend(fam["kernels"])
    return out
