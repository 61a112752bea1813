"""A run's last line, its guard against JAX, its refusal without a card,
the trace reader and the roofline's yardstick."""

import ast
import json
import pathlib
import sys
import time
import types

import pytest
import torch

from bench import run as runner
from bench.harness import cell, registry
from bench.harness.trace import Trace, short
from bench.harness.yardstick import least_seconds
from bench.tests.conftest import TINY, tiny

BENCH_DIR = pathlib.Path(runner.__file__).parent
TOP_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("name", ["ct512-f32-resident", "ct512-f32-frames"])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line_has_the_contracts_keys(bench, trace, name):
    out = cell.run(bench, name, 2 ** 31 + 5, 0.5,
                   bool(trace), torch.device("cpu"), time.perf_counter(),
                   overrides=tiny(bench, name))
    line = json.loads(runner.result_line(out))
    assert set(line) == TOP_KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = {m["name"] for m in registry.metrics(
        bench, name, "per_layer" if trace else "end_to_end")}
    assert set(line["metrics"]) <= want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    dev = line["device"]
    keys = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(dev) == keys | ({"busy_s", "window_s"} if trace else set())
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_without_a_card_it_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = runner.main(["--workload", "ct512-f32-host31", "--seed", "3",
                      "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_the_guard_names_jax_and_the_jax_package(monkeypatch):
    assert runner.banned_modules() == [] or all(
        m.split(".")[0] in runner.BANNED for m in runner.banned_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType("x"))
    assert "repro_torch_fake" not in runner.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro.core" in runner.banned_modules()


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in runner.BANNED, \
                    f"{path} imports {name}"


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_the_trace_reader():
    events = [
        _x("bench.window", 1000.0, 10000.0, "user_annotation"),
        _x("bench.window", 1000.0, 10000.0, "gpu_user_annotation"),
        _x("bench.submit", 1000.0, 3000.0, "user_annotation"),
        _x("aten::copy_", 1500.0, 2000.0, "cpu_op"),
        _x("void k<float>(float*)", 1000.0, 1000.0, "kernel"),
        _x("void k<float>(float*)", 1500.0, 1000.0, "kernel"),
        _x("Memcpy HtoD", 4000.0, 2000.0, "gpu_memcpy"),
        _x("void other(int)", 9000.0, 500.0, "kernel"),
    ]
    tr = Trace(events)
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s() == pytest.approx(0.0015 + 0.002 + 0.0005)
    assert tr.gaps() == pytest.approx([(0.0015, 0.003), (0.005, 0.008),
                                       (0.0085, 0.010)])
    assert tr.device_s(lambda n: "k<" in n) == pytest.approx(0.002)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k", pytest.approx(0.002)]
    assert b["idle_gaps"][0] == ["event loop", pytest.approx(0.003)]
    assert b["idle_gaps"][1][0] == "submit: aten::copy_"
    assert short("void ns::f<ns::T>(float*, int)") == "ns::f"


def test_the_benchmarks_own_device_work_is_named_and_not_ingest():
    def launch(ts, cid):
        return {"ph": "X", "name": "cudaLaunchKernel", "ts": ts, "dur": 5.0,
                "cat": "cuda_runtime", "tid": 7, "args": {"correlation": cid}}

    def kernel(name, ts, cid):
        return {"ph": "X", "name": name, "ts": ts, "dur": 1000.0,
                "cat": "kernel", "tid": 9, "args": {"correlation": cid}}

    events = [
        _x("bench.window", 0.0, 10000.0, "user_annotation"),
        dict(_x("bench.submit", 100.0, 50.0, "user_annotation"), tid=7),
        launch(110.0, 1),
        dict(_x("bench.sample", 300.0, 50.0, "user_annotation"), tid=7),
        launch(310.0, 2),
        launch(400.0, 3),
        kernel("void copy_kernel(float*)", 1000.0, 1),
        kernel("void at::native::indexSelect<float>(float*)", 3000.0, 2),
        kernel("void backproject_batch_kernel<F32Taps>(float*)", 5000.0, 3),
    ]
    tr = Trace(events)
    names = [n for _, _, n in tr.device]
    assert names[1] == \
        "bench.sample: void at::native::indexSelect<float>(float*)"
    assert [tr.own(n) for n in names] == [False, True, False]
    assert short(names[1]) == "bench.sample: at::native::indexSelect"
    assert tr.busy_s() == pytest.approx(0.003)
    ctx = types.SimpleNamespace(
        trace=tr, folds=8, scans_folded=2.0,
        layer=lambda name: (lambda n: "backproject_batch_kernel" in n)
        if name == "back projection" else (lambda n: False))
    ingest = registry.reader("ingest_device_ms").read(ctx)
    assert ingest == pytest.approx(1e3 * 0.001 / 2.0)


def test_the_roofline_yardstick_at_rabbitct_size():
    L, n_proj, n_v, n_u = 512, 496, 960, 1248
    pairs = L ** 3 * n_proj
    assert 37 * pairs == pytest.approx(2.463e12, rel=1e-3)
    assert least_seconds(pairs, L, n_proj, n_v, n_u) == \
        pytest.approx(36.76e-3, rel=1e-3)
    bytes_s = (L ** 3 * 4 + n_proj * n_v * n_u * 4) / 3.35e12
    assert bytes_s == pytest.approx(0.87e-3, rel=1e-2)


@pytest.mark.parametrize("config", ["rabbitct-512-f32", "rabbitct-512-int8"])
def test_the_roofline_counts_the_same_work_for_any_depth(bench, config):
    """The pairs come from the views folded, which neither the wire nor
    ``pbatch`` changes, so the least time is the same."""
    from bench.harness.cell import _merge, program
    from bench.harness.inputs import Inputs
    from bench.reference.geometry import Scan
    from repro_torch.api import ProjectionChunk

    cfg = _merge(registry.config(bench, config), TINY["config"])
    scan = Scan.from_config(cfg["geometry"])
    inputs = Inputs(scan, 5, 1, "device", torch.device("cpu"))
    reader = registry.reader("backproject_roofline")
    reads = set()
    for pbatch in (1, 3, 8):
        cfg["engine"]["pbatch"] = pbatch
        fd, engine = program(cfg, scan, torch.device("cpu"))
        sid = engine.begin_scan()
        for c in range(scan.n_proj // 8):
            engine.submit(sid, ProjectionChunk(*inputs.chunk(0, c, 8)))
        engine.drain()
        ctx = types.SimpleNamespace(
            trace=types.SimpleNamespace(device_s=lambda match: 0.25),
            folds=engine.stats["folds"], layer=lambda name: None,
            scan=scan)
        reads.add(reader.read(ctx))
    assert len(reads) == 1
    assert reads.pop() == pytest.approx(100 * least_seconds(
        scan.L ** 3 * scan.n_proj, scan.L, scan.n_proj, scan.n_v,
        scan.n_u) / 0.25)
