"""The harness finds every part ``BENCHMARK.json`` names, by name, and
fails loudly on a name that has no file."""

import json
import re

import pytest

from bench.harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_parts(bench):
    for cell in bench["workloads"]:
        assert registry.cell(bench, cell["name"]) is cell
        cfg = registry.config(bench, cell["config"])
        assert cfg["name"] == cell["config"]
        traffic = registry.traffic(cell["traffic"])
        assert traffic["chunk"] > 0 and traffic["clients"] > 0
        assert registry.limits(cell["config"])["checks"]
        for kind in ("end_to_end", "per_layer"):
            assert registry.metrics(bench, cell["name"], kind)


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.reader(m["name"]).read)


def test_kernel_families_name_the_layers_the_metrics_read():
    fams = registry.families()
    assert fams["back projection"] and fams["encoder"]
    assert all(isinstance(k, str) and k for ks in fams.values() for k in ks)


@pytest.mark.parametrize("what, call", [
    ("workload", lambda b: registry.cell(b, "no-such-cell")),
    ("configuration", lambda b: registry.config(b, "no-such-config")),
    ("traffic", lambda b: registry.traffic("no-such-mix")),
    ("limits", lambda b: registry.limits("no-such-config")),
    ("reader", lambda b: registry.reader("no_such_metric")),
])
def test_an_unknown_name_fails_loudly(bench, what, call):
    with pytest.raises(registry.NotFound, match="no-such|no_such"):
        call(bench)


def test_a_traffic_key_nothing_reads_fails_loudly(tmp_path, monkeypatch):
    (tmp_path / "traffic").mkdir()
    mix = registry.traffic("host31")
    (tmp_path / "traffic" / "paced.json").write_text(
        json.dumps(dict(mix, loop="open")))
    monkeypatch.setattr(registry, "BENCH", tmp_path)
    with pytest.raises(ValueError, match="loop"):
        registry.traffic("paced")


def test_the_file_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    cfgs = {c["name"] for c in bench["configs"]}
    assert {w["config"] for w in bench["workloads"]} == cfgs
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in bench["end_to_end"]:
        assert 0.0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(bench)) < 64 * 1024
