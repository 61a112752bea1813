"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

- The per-cell policy: ``pick_rules``, ``pick_opt``, ``input_specs`` and
  the decode cache's logical specs (``_cache_logical_specs``, on each
  package's own cache at full size) equal the reference's for every arch
  x shape on both production meshes, given as stand-ins with the mesh's
  names and sizes.  The reference's module sets ``XLA_FLAGS`` to 512
  devices as it is imported, so it runs in a child process.
- The inventory: 40 cells per mesh, the 8 skipped ``long_500k`` cells
  the reference's.
- One cell per step kind on the fake world of 256 ranks (cut in depth
  and shape so that each traces in seconds; widths are the published
  ones, which ``tp`` = 16 must divide): a train step (chatglm3-6b, one
  layer), a prefill (qwen3-moe-235b-a22b, one MoE layer), a decode step
  (jamba-v0.1-52b, one period, with the one-hot gather, whose kernel op
  the census counts), and xlstm-125m's decode, whose 4 mLSTM heads
  ``tp`` = 16 does not divide: an ``ok`` record, the mLSTM run whole on
  the rank (the divisibility guard), its parameters counted whole among
  the rank's argument bytes.  Their records carry the reference's keys
  and render through the report.  The fake process group is global to
  the process, so the file tears it down.

About 15 s in one process (``--durations``: the reference's child 5 s,
the four cells 6 s together; xlstm-125m's decode, which stopped at the
error before, now traces in about 1 s).
"""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch.distributed as dist

from repro.configs.registry import cells as ref_cells
from repro_torch.analysis import report
from repro_torch.configs import SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCHS, cells
from repro_torch.launch import dryrun
from repro_torch.models.model import init_cache

REPO = Path(__file__).resolve().parent.parent
MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}

_REF = r"""
import dataclasses, functools, json, sys, types
from repro.launch import dryrun as D
import jax
from repro.configs import SHAPES
from repro.configs.registry import ARCHS
from repro.models.model import init_cache

meshes = json.loads(sys.argv[1])
out = {}
for mname, sizes in meshes.items():
    mesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=sizes)
    for a, cfg in ARCHS.items():
        for s, shape in SHAPES.items():
            rec = {"rules": dataclasses.asdict(D.pick_rules(cfg, shape,
                                                            mesh)),
                   "opt": D.pick_opt(cfg).state_dtype,
                   "inputs": {k: [list(v.shape), str(v.dtype)] for k, v in
                              D.input_specs(cfg, shape).items()}}
            if shape.is_decode and mname == "pod":
                enc = shape.seq_len if cfg.enc_dec else 0
                cache = jax.eval_shape(functools.partial(
                    init_cache, cfg, shape.global_batch, shape.seq_len, enc))
                rec["cache"] = D._cache_logical_specs(cfg, cache)
            out[f"{mname}/{a}/{s}"] = rec
print(json.dumps(out))
"""


def _plain(x):
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REF, json.dumps(MESHES)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


def test_policy_and_specs_equal_the_reference(reference):
    n = 0
    for mname, sizes in MESHES.items():
        mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                     shape=tuple(sizes.values()))
        for a, cfg in ARCHS.items():
            for s, shape in SHAPES.items():
                want = reference[f"{mname}/{a}/{s}"]
                rules = dryrun.pick_rules(cfg, shape, mesh)
                assert _plain(dataclasses.asdict(rules)) == want["rules"]
                assert dryrun.pick_opt(cfg).state_dtype == want["opt"]
                assert {k: [list(v.shape),
                            str(v.dtype).removeprefix("torch.")]
                        for k, v in dryrun.input_specs(cfg, shape).items()
                        } == want["inputs"]
                if "cache" in want:
                    enc = shape.seq_len if cfg.enc_dec else 0
                    cache = init_cache(cfg, shape.global_batch,
                                       shape.seq_len, enc, device="meta")
                    assert _plain(dryrun._cache_logical_specs(cfg, cache)) \
                        == want["cache"], (a, s)
                n += 1
    assert n == 2 * 40


def test_inventory_equals_the_reference():
    ours = {(c.name, s.name): ok for c, s, ok, _ in cells()}
    ref = {(c.name, s.name): ok for c, s, ok, _ in ref_cells()}
    assert ours == ref and len(ours) == 40
    skipped = sorted(k for k, ok in ours.items() if not ok)
    assert len(skipped) == 8 and {s for _, s in skipped} == {"long_500k"}


# ----------------------------------------------------------------------
# Cells on the fake world
# ----------------------------------------------------------------------

CELLS = {
    "train": (dataclasses.replace(ARCHS["chatglm3-6b"], n_layers=1),
              ShapeConfig("train_small", 128, 16, "train")),
    "prefill": (dataclasses.replace(ARCHS["qwen3-moe-235b-a22b"],
                                    n_layers=1),
                ShapeConfig("prefill_small", 128, 16, "prefill")),
    "decode": (dataclasses.replace(ARCHS["jamba-v0.1-52b"], n_layers=8,
                                   gather_impl="onehot"),
               ShapeConfig("decode_small", 256, 16, "decode")),
    "indivisible": (ARCHS["xlstm-125m"], SHAPES["decode_32k"]),
}

# The reference's record keys of an ok cell, and the port's changes:
# trace_s for lower_s/compile_s, fits_80gb_hbm for fits_16gb_hbm, the
# cost's gather bytes and kernel launches for XLA's unweighted flops.
REF_KEYS = {"arch", "shape", "mesh", "chips", "model_params",
            "active_params", "step", "rules", "lower_s", "compile_s",
            "memory", "fits_16gb_hbm", "cost", "roofline", "model_flops",
            "useful_flops_ratio", "status"}
RENAMED = {"lower_s": "trace_s", "compile_s": "trace_s",
           "fits_16gb_hbm": "fits_80gb_hbm"}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    try:
        recs = {k: dryrun.run_cell(cfg, shape, "pod", out_dir=str(out),
                                   verbose=False)
                for k, (cfg, shape) in CELLS.items()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return recs, out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_a_cell_of_each_step_kind(records, kind):
    rec = records[0][kind]
    assert rec["status"] == "ok", rec.get("traceback")
    assert {RENAMED.get(k, k) for k in REF_KEYS} <= set(rec)
    assert rec["chips"] == 256 and rec["mesh"] == "pod"
    assert rec["step"] == {"train": "train_step", "prefill": "prefill_step",
                           "decode": "serve_step"}[kind]
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes", "peak_bytes",
                                  "live_bytes"}
    assert rec["memory"]["live_bytes"] == rec["memory"]["argument_bytes"] \
        + rec["memory"]["temp_bytes"] > 0
    cost = rec["cost"]
    assert cost["flops_per_device"] > 0 and cost["bytes_accessed_per_device"] \
        > 0
    # FSDP gathers each layer's parameters over data = 16.
    assert cost["collective_bytes_per_device"]["all-gather"] > 0
    assert rec["roofline"]["bound_s"] > 0 and rec["useful_flops_ratio"] > 0
    assert rec["fake_device"] == dryrun.fake_device(CELLS[kind][1])
    if kind == "train":
        assert rec["opt_state"] == "float32"
    if kind == "decode":
        assert cost["kernel_launches"] == {"onehot_gather": 1}
        assert rec["memory"]["argument_parts"]["cache"] > 0
        assert "the reference shards them over sp" in rec["kv_layout"]
        assert rec["cache_bytes_reference_layout"] > 0


def test_an_indivisible_leaf_is_an_error_record(records):
    """No longer an error: the cell is ``ok``, the mLSTM run whole on the
    rank, and its argument bytes count each leaf as the reference's
    ``valid_spec`` places it: ``gates`` (2 x 4 heads wide, which tp = 16
    does not divide) whole over ``tp``, split over ``data`` only."""
    from repro_torch.dist.sharding import logical_to_spec, valid_spec
    from repro_torch.models.model import abstract_params, param_specs

    rec = records[0]["indivisible"]
    assert rec["status"] == "ok", rec.get("traceback")
    cfg, shape = CELLS["indivisible"]
    sizes = MESHES["pod"]
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 shape=tuple(sizes.values()))
    rules = dryrun.pick_rules(cfg, shape, mesh)
    specs = param_specs(cfg)
    shards = {}
    want = 0
    for name, p in abstract_params(cfg).named_parameters():
        spec = valid_spec(tuple(p.shape),
                          logical_to_spec(specs[name], rules, mesh), mesh)
        n = 1
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                n *= sizes[a] if a else 1
        shards[name] = n
        want += p.numel() * p.element_size() // n
    assert shards["layers.0.mixer.gates"] == 16
    assert shards["layers.0.mixer.qkv"] == 256
    assert rec["memory"]["argument_parts"]["params"] == want


def test_the_report_renders_the_records(records):
    recs = report.load(str(records[1]))
    assert len(recs) == 4
    assert report.summary(recs).splitlines()[0] == \
        "cells: 4 ok, 0 skipped, 0 error"
    table = report.roofline_table(recs, "pod").splitlines()
    assert len(table) == 2 + 4
    assert sum("ERROR" in line for line in table) == 0
    assert not dist.is_initialized()
