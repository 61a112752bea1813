"""The port's row quantiser (the int8 projection wire) against
``repro.quant`` on the CPU.

The encode is held **bitwise**: codes, scales and offsets.  Both sides
run the same float32 operations in the same order (a column loop
carrying the residual along each row; the reference's ``lax.scan``), so
any difference is a bug, not rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.quant as jq
from repro.kernels.backproject_ops import _encode_padded_stack
from repro_torch import convert
from repro_torch.quant import (RowQuant, dequantize_rows, quantize_ef,
                               quantize_rows)


def _image(seed, shape=(20, 50)):
    """Seeded rows of every kind the wire meets: mixed sign, all zero,
    constant, all negative, all positive, one huge outlier."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[1] = 0.0
    x[4] = 2.5
    x[6] = -np.abs(x[6])
    x[8] = np.abs(x[8])
    x[10, 7] = 1e4
    return x


def _same(port: RowQuant, ref) -> None:
    np.testing.assert_array_equal(port.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(port.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(port.offset.numpy(),
                                  np.asarray(ref.offset))


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("seed,shape", [(0, (20, 50)), (1, (12, 130)),
                                        (2, (33, 41))])
def test_quantize_rows_bitwise_equals_reference(seed, shape, symmetric):
    x = _image(seed, shape)
    _same(quantize_rows(torch.tensor(x), symmetric=symmetric),
          jq.quantize_rows(jnp.asarray(x), symmetric=symmetric))


def test_stack_encodes_each_image_as_the_reference():
    x = np.stack([_image(s) for s in (3, 4, 5)])
    port = quantize_rows(torch.tensor(x))
    ref = jax.vmap(jq.quantize_rows)(jnp.asarray(x))
    _same(port, ref)
    assert port.scales().shape == (3, 2, 20)
    assert torch.equal(port.scales()[:, 1], port.offset)


def test_dequantize_bitwise_and_zero_rows_decode_to_zero():
    x = _image(6)
    port = quantize_rows(torch.tensor(x))
    ref = jq.quantize_rows(jnp.asarray(x))
    deq = dequantize_rows(port)
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(jq.dequantize_rows(ref)))
    assert torch.all(port.codes[1] == -127)
    assert torch.equal(deq[1], torch.zeros(50))
    # The error feedback keeps every row prefix within about one step.
    step = port.scale[:, None]
    prefix = torch.cumsum(deq - torch.tensor(x), dim=1).abs()
    assert bool((prefix <= step * 1.01).all())


@pytest.mark.parametrize("with_offset", [False, True])
@pytest.mark.parametrize("with_error", [False, True])
def test_quantize_ef_matches_reference(with_offset, with_error):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(64).astype(np.float32)
    e = (rng.standard_normal(64) * 0.01).astype(np.float32)
    scale, off = np.float32(0.03), np.float32(0.3)
    kw_j = {"error": jnp.asarray(e)} if with_error else {}
    kw_t = {"error": torch.tensor(e)} if with_error else {}
    q_j, e_j = jq.quantize_ef(jnp.asarray(x), jnp.float32(scale),
                              jnp.float32(off) if with_offset else None,
                              **kw_j)
    q_t, e_t = quantize_ef(torch.tensor(x), torch.tensor(scale),
                           torch.tensor(off) if with_offset else None,
                           **kw_t)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))


def test_one_pixel_pad_encode_equals_pallas_wrapper_encode():
    """The port encodes the 1-pixel-padded stack; the Pallas wrapper
    pads further (rows to 32, columns to 128) before encoding.  Rows
    are independent and the residual runs left to right, so on the
    shared ``[:n_v+2, :n_u+2]`` region the two encodings are equal."""
    imgs = np.stack([_image(8, (18, 37)), _image(9, (18, 37))])
    imgs[1, 5] = 0.0
    codes, scales = _encode_padded_stack(jnp.asarray(imgs), 16, 128)
    port = quantize_rows(torch.nn.functional.pad(torch.tensor(imgs),
                                                 (1, 1, 1, 1)))
    np.testing.assert_array_equal(port.codes.numpy(),
                                  np.asarray(codes)[:, :20, :39])
    np.testing.assert_array_equal(port.scales().numpy(),
                                  np.asarray(scales)[:, :, :20])


def test_rowquant_carried_from_reference():
    x = np.stack([_image(10), _image(11)])
    ref = jax.vmap(jq.quantize_rows)(jnp.asarray(x))
    got = convert.rowquant_from_reference(
        tuple(np.asarray(a) for a in ref), device="cpu")
    _same(got, ref)
    np.testing.assert_array_equal(
        dequantize_rows(got).numpy(),
        np.asarray(jax.vmap(jq.dequantize_rows)(ref)))
    with pytest.raises(TypeError, match="int8"):
        convert.rowquant_from_reference(
            (np.asarray(ref.codes, np.int16), ref.scale, ref.offset),
            device="cpu")
    with pytest.raises(ValueError, match="scale/offset"):
        convert.rowquant_from_reference(
            (np.asarray(ref.codes), np.asarray(ref.scale)[:, :3],
             np.asarray(ref.offset)), device="cpu")


def test_quantize_rows_rejects_bad_input():
    with pytest.raises(ValueError, match="rows"):
        quantize_rows(torch.zeros(4))
    with pytest.raises(TypeError, match="float32"):
        quantize_rows(torch.zeros(3, 4, dtype=torch.float64))
    from repro_torch.kernels.quant import launch_quantize_rows

    with pytest.raises(ValueError, match="CUDA"):
        launch_quantize_rows(torch.zeros(1, 3, 4))

