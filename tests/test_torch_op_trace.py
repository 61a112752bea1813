"""The census of the eager port: ``repro_torch.analysis.trace`` and
``repro_torch.analysis.census``, and the kernels as custom ops.

- Every hand-written kernel's launcher goes through a ``repro_torch::``
  custom op: on fake CUDA tensors it reaches the op's fake
  implementation (no launch counted, outputs of the kernel's shapes),
  :class:`OpTrace` and PyTorch's flop counter see it, and its
  operations and bytes are ``census.KERNEL_TERMS``'s.  Row 1's byte
  term at a served fold (L = 512, P = 4) is PERF.md's 0.3263 ms bound.
- ``flops``, ``bytes`` and collective bytes against hand counts on a toy
  function, an all-reduce and an all-gather on a fake world of 4 ranks
  included (the reference's convention: output bytes, all-reduce
  doubled); a Python loop counted every iteration (nothing to weight).
- A reduced chatglm3-6b forward: the trace's flops against the
  reference's ``analyze_module`` on its compiled HLO (within 2 %: the
  reference adds one flop per element at fusion boundaries), and the
  same forward on real CPU tensors and on fake CUDA tensors giving equal
  flops and bytes.

About 10 s in one process (``--durations``: the reference's compile 2 s,
the fake CUDA device guard's first build 2 s, the rest under 1 s each).
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis.hlo_module import analyze_module
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.models import model as ref_model
from repro_torch.analysis import census, collective_bytes, op_census, \
    parse_shape_bytes
from repro_torch.analysis.trace import OpTrace, analyze_trace, type_string
from repro_torch.configs import ARCHS
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.backproject import (launch_backproject,
                                             launch_strip, pitch_stack)
from repro_torch.kernels.gather import (launch_onehot_gather,
                                        launch_onehot_gather_grad)
from repro_torch.kernels.quant import launch_quantize_rows
from repro_torch.kernels.slstm import (launch_slstm, launch_slstm_backward,
                                       launch_slstm_train)
from repro_torch.launch.dryrun import _fake_cuda_guard, fake_world
from repro_torch.models import model as tmodel


@pytest.fixture
def fake_cuda():
    """Fake CUDA tensors (the dry run's), no card."""
    _fake_cuda_guard()
    with FakeTensorMode():
        yield torch.device("cuda", 0)


# ----------------------------------------------------------------------
# The kernels as custom ops
# ----------------------------------------------------------------------

def test_every_kernel_reaches_its_fake_implementation(fake_cuda):
    dev, f32 = fake_cuda, torch.float32
    before = dict(LAUNCHES)
    table = torch.empty(100, 16, device=dev, dtype=torch.bfloat16)
    ids = torch.zeros(7, dtype=torch.int64, device=dev)
    zifo = torch.empty(2, 5, 4, 8, device=dev)
    r, state = torch.empty(4, 8, device=dev), torch.empty(4, 2, 8, device=dev)
    vol = torch.empty(16, 32, 32, device=dev)
    padded = torch.empty(4, 30, 40, device=dev)
    mats = torch.empty(4, 3, 4, device=dev)
    with OpTrace() as tr, FlopCounterMode(display=False) as fc:
        out = launch_onehot_gather(table, ids, 3)
        dtab = launch_onehot_gather_grad(ids, out, 100, 3)
        hs, final = launch_slstm(zifo, r, state)
        hs2, final2, states = launch_slstm_train(zifo, r, state)
        dz, dr = launch_slstm_backward(zifo, r, state, hs2, states, hs2)
        launch_backproject(vol, padded, mats, z0=0, O=1.0, MM=2.0)
        codes, scales = launch_quantize_rows(padded)
        launch_strip(vol, pitch_stack(torch.empty(4, 30, 40, device=dev)),
                     mats, kind="db", z0=0, O=1.0, MM=2.0, n_u=38, n_v=28,
                     ty=8, chunk=32, band=8, width=16, pad_rows=30,
                     pad_cols=40)
    assert LAUNCHES == before
    assert (out.shape, out.dtype, out.device) == ((7, 16), torch.bfloat16,
                                                  dev)
    assert dtab.shape == (100, 16) and dtab.dtype == torch.bfloat16
    assert hs.shape == (2, 5, 8) and final.shape == (4, 2, 8)
    assert states.shape == (2, 5, 3, 8) and dz.shape == zifo.shape
    assert dr.shape == (4, 8) and dr.dtype == f32
    assert codes.dtype == torch.int8 and scales.shape == (4, 2, 30)
    ops = {k: v for k, v in tr.counts().items()
           if k.startswith("repro_torch.")}
    assert ops == {f"repro_torch.{k}": 1 for k in census.KERNEL_TERMS}
    for rec in tr.records:
        if rec.name.startswith("repro_torch."):
            op = rec.name.split(".")[1]
            assert fc.get_flop_counts()["Global"][
                getattr(torch.ops.repro_torch, op)] == rec.flops
    (bp,) = [x for x in tr.records if x.name == "repro_torch.backproject"]
    assert (bp.flops, bp.bytes) == census.backproject_terms(32, 16, 4, 30,
                                                            40)


def test_a_cpu_tensor_never_reaches_a_kernel_op():
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.onehot_gather(torch.zeros(4, 8),
                                            torch.zeros(2, dtype=torch.long),
                                            0)


def test_row1_byte_term_is_the_tables_bound(fake_cuda):
    """A served fold of row 1 at RabbitCT width: L = 512, P = 4 of the
    1248 x 960 detector's bordered images, traced: its byte term is
    the 0.3263 ms of PERF.md's kernel table, by the same formula."""
    vol = torch.empty(512, 512, 512, device=fake_cuda)
    padded = torch.empty(4, 962, 1250, device=fake_cuda)
    mats = torch.empty(4, 3, 4, device=fake_cuda)
    with OpTrace() as tr:
        launch_backproject(vol, padded, mats, z0=0, O=1.0, MM=2.0)
    (rec,) = tr.records
    ms = 1e3 * census.roofline_terms(0, rec.bytes, 0)["memory_s"]
    assert (ms, "bytes") == census.bound_ms(
        *census.backproject_terms(512, 512, 4, 962, 1250))
    assert f"{ms:.4f}" == "0.3263"


# ----------------------------------------------------------------------
# Hand counts
# ----------------------------------------------------------------------

def test_toy_function_against_hand_counts():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with OpTrace() as tr:
        c = a @ b
        d = c + 1
        e = d.t()
        (e * 2).sum()
    got = analyze_trace(tr)
    assert got["flops"] == 2 * 8 * 16 * 4
    # mm: operands and result; add, mul: operand and result; sum: its
    # operand and a 0-d result; t(): a view, nothing moved.
    assert got["bytes"] == 4 * ((128 + 64 + 32) + 2 * 32 + 2 * 32 + 33)
    assert got["census"] == {"arith": 4, "shuffle": 1, "total": 5}
    assert [r.outputs for r in tr.records][0] == ("f32[8,4]",)
    assert parse_shape_bytes(" ".join(tr.records[0].inputs)) == 4 * 192


def test_a_loop_is_counted_every_iteration():
    x, w = torch.randn(4, 8), torch.randn(8, 8)
    with OpTrace() as tr:
        for _ in range(12):
            x = torch.tanh(x @ w)
    assert analyze_trace(tr)["flops"] == 12 * 2 * 4 * 8 * 8
    assert tr.counts()["aten.mm"] == 12


def test_collective_bytes_on_a_fake_world():
    fake_world(4)
    try:
        x = torch.randn(10)
        out = torch.empty(40)
        with OpTrace() as tr:
            dist.all_reduce(x)
            dist.all_gather_into_tensor(out, x)
    finally:
        dist.destroy_process_group()
    got = analyze_trace(tr)
    assert got["collectives"] == {"all-reduce": 2 * 40, "all-gather": 160,
                                  "total": 240}
    assert got["bytes"] == 0
    assert collective_bytes([("c10d.allreduce_", 8),
                             ("aten.mm", 99)]) == {"all-reduce": 16,
                                                   "total": 16}


def test_op_classes():
    assert op_census(["aten.mm", "aten.mm", "aten.index_select",
                      "repro_torch.onehot_gather", "repro_torch.slstm",
                      "aten.permute", "aten.copy_", "c10d.allreduce_"]) \
        == {"classes": {"arith": 3, "gather": 2, "shuffle": 1,
                        "memory": 1, "other": 1, "total": 8},
            "ops": {"aten.mm": 2, "aten.index_select": 1,
                    "repro_torch.onehot_gather": 1, "repro_torch.slstm": 1,
                    "aten.permute": 1, "aten.copy_": 1,
                    "c10d.allreduce_": 1}}
    assert census.op_class("repro_torch.backproject_strip") == "gather"
    assert type_string(torch.zeros(2, 3, dtype=torch.bfloat16)) == \
        "bf16[2,3]"


# ----------------------------------------------------------------------
# A reduced model
# ----------------------------------------------------------------------

B, S = 4, 32


def _port_forward(dev):
    cfg = ARCHS["chatglm3-6b"].reduced()
    m = tmodel.init_model(cfg, generator=torch.Generator(), device=dev)
    toks = torch.zeros((B, S), dtype=torch.int64, device=dev)
    with torch.no_grad(), OpTrace() as tr:
        tmodel.forward(m, cfg, {"tokens": toks})
    return analyze_trace(tr)


def test_flops_against_the_reference_hlo():
    rcfg = REF_ARCHS["chatglm3-6b"].reduced()
    hlo = jax.jit(lambda p, b: ref_model.forward(p, rcfg, b)).lower(
        ref_model.abstract_params(rcfg),
        {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}).compile() \
        .as_text()
    want = analyze_module(hlo)["flops"]
    got = _port_forward("cpu")["flops"]
    gap = (want - got) / want
    print(f"reduced chatglm3-6b forward ({B}x{S}): traced {got:.0f} flops, "
          f"the reference's HLO {want:.0f}: gap {gap:.4%} (its one flop "
          f"per element at fusion boundaries)")
    assert 0 <= gap < 0.02


def test_real_cpu_and_fake_cuda_agree(fake_cuda):
    fake = _port_forward(fake_cuda)
    with torch._subclasses.fake_tensor.unset_fake_temporarily():
        real = _port_forward("cpu")
    for k in ("flops", "bytes", "gather_bytes", "census"):
        assert real[k] == fake[k], k
    assert real["flops"] > 0 and real["bytes"] > 0
