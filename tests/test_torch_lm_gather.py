"""Kernel row 9 (the one-hot gather) and the port's gather strategies
against the JAX package on the same numpy inputs, on the CPU.

The one-hot product sums exactly one nonzero term, so every comparison
here is bitwise: the port's plain version (``kernels/gather_ref.py``),
its wrapper on a CPU table, and ``core/gather_ops.py``'s ``take``,
``onehot`` (the chunked product) and ``auto`` against the reference's
``gather_ref``, ``pallas_onehot_gather`` (interpret mode) and
``gather_ops``, with ids outside ``[0, V)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gather_ops as ref_ops
from repro.kernels.gather_kernel_ops import pallas_onehot_gather
from repro.kernels.gather_ref import gather_ref as ref_gather_ref
from repro.models import layers as ref_layers
from repro_torch.core import gather_ops
from repro_torch.kernels.gather_kernel_ops import cuda_onehot_gather
from repro_torch.kernels.gather_ref import gather_ref
from repro_torch.models import layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(V, D, shape, dtype, seed=0):
    """A table and ids (with -1, V and V + 5 mixed in) for both sides."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, size=shape).astype(np.int32)
    flat = ids.reshape(-1)
    for k, bad in enumerate((-1, V, V + 5)):
        if k < flat.size:
            flat[k] = bad
    jd, td = DTYPES[dtype]
    return (jnp.asarray(table).astype(jd), jnp.asarray(ids),
            torch.tensor(table).to(td), torch.tensor(ids))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,D,shape", [(50, 16, (9,)), (300, 24, (2, 7)),
                                       (1, 8, (3,))])
def test_plain_version_equals_reference_oracle(dtype, V, D, shape):
    jt, jids, tt, tids = _case(V, D, shape, dtype)
    got = gather_ref(tt, tids)
    _same(got, ref_gather_ref(jt, jids))
    assert got.dtype == tt.dtype
    # The wrapper on a CPU table runs the plain version.
    _same(cuda_onehot_gather(tt, tids), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V,D,shape", [(512, 16, (8,)), (700, 32, (3, 5)),
                                       (37, 8, (11,))])
def test_onehot_equals_pallas_kernel_interpret(dtype, V, D, shape):
    """The reference's Pallas kernel (interpret mode, padded to its tiles)
    against the port's wrapper and its ``onehot`` strategy, bitwise; V
    and N need no tile multiples in the port."""
    jt, jids, tt, tids = _case(V, D, shape, dtype, seed=1)
    want = pallas_onehot_gather(jt, jids, interpret=True)
    _same(cuda_onehot_gather(tt, tids), want)
    _same(gather_ops.onehot_gather(tt, tids), want)


@pytest.mark.parametrize("chunk", [7, 64, 2048])
def test_onehot_chunks_equal_reference(chunk):
    jt, jids, tt, tids = _case(300, 16, (4, 6), "float32", seed=2)
    _same(gather_ops.onehot_gather(tt, tids, chunk=chunk),
          ref_ops.onehot_gather(jt, jids, chunk=chunk))


def test_take_clamps_as_reference():
    jt, jids, tt, tids = _case(90, 12, (2, 9), "float32", seed=3)
    got = gather_ops.take_gather(tt, tids)
    _same(got, ref_ops.take_gather(jt, jids))
    # Clamped, not zeroed: id -1 reads row 0, id V reads row V - 1.
    assert torch.equal(got[0, 0], tt[0]) and torch.equal(got[0, 1], tt[-1])


@pytest.mark.parametrize("V", [64, 1024, 1025, 3000])
def test_auto_dispatch_follows_the_reference(V):
    """``auto``: the one-hot path (zero rows out of range) up to
    ONEHOT_AUTO_MAX_ROWS, ``take`` (clamped) above."""
    assert gather_ops.ONEHOT_AUTO_MAX_ROWS == ref_ops.ONEHOT_AUTO_MAX_ROWS
    jt, jids, tt, tids = _case(V, 8, (6,), "float32", seed=4)
    got = gather_ops.gather(tt, tids, impl="auto")
    _same(got, ref_ops.gather(jt, jids, impl="auto"))
    assert bool((got[0] == 0).all()) == (V <= 1024)
    for impl in ("take", "onehot"):
        _same(gather_ops.gather(tt, tids, impl=impl),
              ref_ops.gather(jt, jids, impl=impl))


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown gather impl"):
        gather_ops.gather(torch.zeros(4, 2), torch.zeros(3, dtype=torch.long),
                          impl="scatter")
    with pytest.raises(ValueError, match=r"\(V, D\)"):
        cuda_onehot_gather(torch.zeros(4), torch.zeros(3, dtype=torch.long))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["take", "onehot"])
def test_embed_lookup_equals_reference(dtype, impl):
    """The sqrt(d) scale is a compute-dtype scalar on both sides: in
    bfloat16 it is rounded before it multiplies, and the lookups agree
    bitwise."""
    jt, jids, tt, tids = _case(200, 48, (2, 5), "float32", seed=5)
    jd, td = DTYPES[dtype]
    got = layers.embed_lookup({"embed": tt}, tids, impl=impl,
                              compute_dtype=td)
    want = ref_layers.embed_lookup({"embed": jt}, jids, impl=impl,
                                   compute_dtype=jd)
    assert got.dtype == td
    _same(got, want)
