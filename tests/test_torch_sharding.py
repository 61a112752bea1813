"""The port's logical-axis sharding rules against the JAX package's.

``logical_to_spec`` and ``valid_spec`` read only a mesh's axis names
and sizes, so both packages resolve every annotation on stand-in meshes
of the shapes the reference runs (1x1, 2x2, a podless 16x16 and the
2x16x16 production mesh), which no test could launch.  The results are
compared entry for entry (a ``PartitionSpec`` is a tuple).
"""

import dataclasses
import types

import pytest

from repro.dist import sharding as jsh
from repro_torch.dist import sharding as tsh

# Every logical annotation the reference's code writes, and some more.
AXES = [("batch", None, "tp"), ("fsdp", "tp"), ("ep", None, None),
        ("vol", None, None), ("proj", None, None), ("sp",), ("sp_act",),
        ("null", "batch"), (None,), ("proj", "vol")]
SHAPES = [(1, 1), (2, 2), (16, 16), (2, 16, 16)]
TENSORS = [(512, 512, 512), (496, 960, 1248), (6, 4, 8), (3, 5),
           (1024, 64, 4096)]


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                             "model")


def _meshes(shape):
    names = _names(shape)
    ref = types.SimpleNamespace(axis_names=names,
                                shape=dict(zip(names, shape)))
    port = types.SimpleNamespace(mesh_dim_names=names, shape=tuple(shape))
    return ref, port


def test_rules_have_the_reference_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(jsh.ShardingRules)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tsh.ShardingRules)]
    assert tf == jf


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("rules", [{}, {"vol": ("data",),
                                        "proj": ("model",)},
                                   {"batch": ("pod", "data", "model"),
                                    "sp": ("model",)}], ids=str)
def test_specs_equal_the_reference(shape, rules):
    jm, tm = _meshes(shape)
    jr, tr = jsh.ShardingRules(**rules), tsh.ShardingRules(**rules)
    for axes in AXES:
        jspec = jsh.logical_to_spec(axes, jr, jm)
        tspec = tsh.logical_to_spec(axes, tr, tm)
        assert tspec == tuple(jspec), axes
        for t in TENSORS:
            want = tuple(jsh.valid_spec(t[:len(axes)], jspec, jm))
            assert tsh.valid_spec(t[:len(axes)], tspec, tm) == want, (axes,
                                                                      t)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    _, tm = _meshes((2, 16, 16))
    assert tsh.spec_to_placements(("data", None, "model"), tm) == (
        Replicate(), Shard(0), Shard(2))
    assert tsh.spec_to_placements((("pod", "data"), None), tm) == (
        Shard(0), Shard(0), Replicate())
    assert tsh.spec_to_placements((), tm) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="shards two"):
        tsh.spec_to_placements(("data", "data"), tm)
    with pytest.raises(ValueError, match="mesh order"):
        tsh.spec_to_placements((("model", "data"),), tm)
    with pytest.raises(ValueError, match="not in the mesh"):
        tsh.spec_to_placements(("pod",), _meshes((2, 2))[1])


def test_constraint_is_the_identity_outside_a_context():
    import torch

    x = torch.arange(12.0).reshape(3, 4)
    assert tsh.shard_constraint(x, ("batch", "tp")) is x
    assert tsh.shard_constraint(x, ("null", None)) is x


@pytest.mark.parametrize("mod", [jsh, tsh], ids=["jax", "torch"])
def test_unknown_logical_axis_raises_in_the_same_words(mod):
    with pytest.raises(ValueError) as exc:
        mod.shard_constraint(None, ("batch", "tensor"))
    assert str(exc.value) == (
        "unknown logical axis 'tensor'; want one of ['batch', 'ep', "
        "'fsdp', 'proj', 'sp', 'sp_act', 'tp', 'vol']")


def test_constraint_inside_a_context_shards_the_full_value():
    """On a 1x1 gloo mesh a plain tensor becomes a DTensor with the
    resolved placements, and its local part is the whole value."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(1, 1, device="cpu")
    try:
        x = torch.arange(24.0).reshape(4, 6)
        with tsh.sharding_context(mesh, tsh.ShardingRules()):
            y = tsh.shard_constraint(x, ("vol", "tp"))
            z = tsh.shard_constraint(y, (None, None))
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert tuple(z.placements) == (Replicate(), Replicate())
        assert torch.equal(y.to_local(), x) and torch.equal(z.full_tensor(),
                                                            x)
    finally:
        dist.destroy_process_group()
