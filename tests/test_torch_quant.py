"""The port's block quantization (``repro_torch.quant``) against the
reference's ``repro.quant``.

The same numpy weights go through both packages; every plane of the
resulting ``QTensor`` must be bit for bit the reference's (same dtype,
shape and bytes), and so must ``dequantize`` and the nibble packing.
Weights carry columns the quantizers treat specially (all zero,
constant, tiny, large, all positive, all negative) beside normal ones.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.quant import dequantize as jax_dequantize  # noqa: E402
from repro.quant import pack_nibbles as jax_pack  # noqa: E402
from repro.quant import quantization_rmse as jax_rmse  # noqa: E402
from repro.quant import quantize as jax_quantize  # noqa: E402
from repro.quant import unpack_nibbles as jax_unpack  # noqa: E402
from repro_torch.convert import qtensor_from_numpy  # noqa: E402
from repro_torch.quant import (FORMATS, QTensor, dequantize,  # noqa: E402
                               get_format, pack_nibbles, quantization_rmse,
                               quantize, unpack_nibbles)

pytestmark = pytest.mark.torch_port
torch.set_num_threads(2)

FMTS = ("q8_0", "q6_k", "q4_k", "q2_k")
SHAPES = ((256, 128), (512, 256), (1024, 128))
PLANES = ("values", "super_scales", "sub_scales", "sub_mins", "super_mins")


def _weights(shape, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[:, 0] = 0.0                                   # zero scale -> 1
    w[:, 1] = 0.75                                  # constant block
    w[:, 2] *= np.float32(1e-30)                    # tiny scales
    w[:, 3] *= np.float32(1e4)                      # large scales
    w[:, 4] = np.abs(w[:, 4])                       # no min offset
    w[:, 5] = -np.abs(w[:, 5])                      # all negative
    w[: shape[0] // 2, 6] = 0.0                     # half-zero column
    return w


def _bits(t) -> np.ndarray:
    arr = np.asarray(t)
    return arr.view(np.uint8 if arr.dtype.itemsize == 1 else np.uint32)


def _same_planes(jqt, tqt):
    assert tqt.fmt == jqt.fmt and tqt.shape == tuple(jqt.shape)
    for name in PLANES:
        a, b = getattr(jqt, name), getattr(tqt, name)
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a)
        b = b.numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, name
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=name)
    assert tqt.nbytes() == jqt.nbytes()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fmt", FMTS)
def test_planes_and_dequantize_bitwise(fmt, shape):
    w = _weights(shape)
    jqt = jax_quantize(jnp.asarray(w), fmt)
    tqt = quantize(torch.from_numpy(w), fmt)
    _same_planes(jqt, tqt)
    np.testing.assert_array_equal(_bits(dequantize(tqt).numpy()),
                                  _bits(jax_dequantize(jqt)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fmt", FMTS)
def test_pack_unpack_match_reference(fmt, shape):
    bits = get_format(fmt).bits
    per = 8 // bits
    rng = np.random.default_rng(1)
    v = rng.integers(0, 1 << bits, size=shape).astype(np.uint8)
    packed = pack_nibbles(torch.from_numpy(v), bits)
    jpacked = np.asarray(jax_pack(jnp.asarray(v), bits))
    assert packed.dtype == torch.uint8
    assert tuple(packed.shape) == (shape[0] // per, shape[1])
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    back = unpack_nibbles(packed, bits)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jax_unpack(jnp.asarray(jpacked),
                                                        bits)))
    np.testing.assert_array_equal(back.numpy(), v)


@pytest.mark.parametrize("fmt", FMTS)
def test_qtensor_from_numpy_equals_port_quantize(fmt):
    w = _weights((512, 64), seed=2)
    jqt = jax.device_get(jax_quantize(jnp.asarray(w), fmt))
    carried = qtensor_from_numpy(fmt, jqt.shape, jqt.values,
                                 jqt.super_scales, jqt.sub_scales,
                                 jqt.sub_mins, jqt.super_mins)
    mine = quantize(torch.from_numpy(w), fmt)
    assert isinstance(carried, QTensor) and carried.fmt == fmt
    for name in PLANES:
        a, b = getattr(carried, name), getattr(mine, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), name
    _same_planes(jqt, carried)


def test_qtensor_from_numpy_refuses_wrong_planes():
    jqt = jax.device_get(jax_quantize(jnp.asarray(_weights((256, 32))),
                                      "q4_k"))
    good = dict(values=jqt.values, super_scales=jqt.super_scales,
                sub_scales=jqt.sub_scales, sub_mins=jqt.sub_mins,
                super_mins=jqt.super_mins)
    qtensor_from_numpy("q4_k", (256, 32), **good)            # accepted
    for name, bad in (("values", jqt.values.astype(np.int8)),
                      ("super_scales", jqt.super_scales.astype(np.float64)),
                      ("sub_scales", jqt.sub_scales[:-1]),
                      ("super_mins", None)):
        with pytest.raises(ValueError):
            qtensor_from_numpy("q4_k", (256, 32), **{**good, name: bad})
    q8 = jax.device_get(jax_quantize(jnp.asarray(_weights((256, 32))),
                                     "q8_0"))
    with pytest.raises(ValueError):          # q8_0 has no sub-scale plane
        qtensor_from_numpy("q8_0", (256, 32), q8.values, q8.super_scales,
                           sub_scales=jqt.sub_scales)


@pytest.mark.parametrize("fmt", FMTS)
def test_quantization_rmse_matches_reference(fmt):
    w = np.random.default_rng(3).standard_normal((512, 64)).astype(
        np.float32)
    assert quantization_rmse(torch.from_numpy(w), fmt) == pytest.approx(
        jax_rmse(jnp.asarray(w), fmt), rel=1e-6)


def test_formats_copied():
    from repro.quant.formats import FORMATS as JAX_FORMATS
    assert {k: vars(v) for k, v in FORMATS.items()} == \
        {k: vars(v) for k, v in JAX_FORMATS.items()}


def test_quantize_input_errors():
    with pytest.raises(ValueError):
        quantize(torch.zeros(256), "q8_0")
    with pytest.raises(ValueError):
        quantize(torch.zeros(100, 8), "q6_k")
    with pytest.raises(KeyError):
        quantize(torch.zeros(256, 8), "q5_k")
