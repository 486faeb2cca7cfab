"""Quantization parity: ``repro_torch.quant.int8`` must be BIT-EXACT with
``repro.quant.int8`` (values and scales), including all-zero rows (scale
1.0 for KV) and exact ties at .5 (round half to even on both sides)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.quant import int8 as jq                           # noqa: E402
from repro_torch.quant import int8 as tq                     # noqa: E402

torch.set_num_threads(2)


def _data(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    x[0] = 0.0                                   # an all-zero row
    return x


def _ties(rows=4):
    """Rows whose max is 127, so scale == 1 exactly and every .5 value is
    an exact tie: half-to-even must pick 2, -4, 0, 6 ... on both sides."""
    x = np.zeros((rows, 16), np.float32)
    x[:, 0] = 127.0
    x[:, 1:9] = [2.5, -3.5, 0.5, -0.5, 5.5, 6.5, -126.5, 1.5]
    return x


@pytest.mark.parametrize("axis", [None, 0, -1, (0, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_int8_bit_exact(axis, seed):
    for x in (_data(seed, (6, 33)), _ties()):
        jqt = jq.quantize_int8(jnp.asarray(x), axis=axis)
        tqt = tq.quantize_int8(torch.from_numpy(x), axis=axis)
        np.testing.assert_array_equal(tqt.values.numpy(),
                                      np.asarray(jqt.values))
        np.testing.assert_array_equal(tqt.scale.numpy(),
                                      np.asarray(jqt.scale))


def test_ties_round_half_to_even():
    q = tq.quantize_int8(torch.from_numpy(_ties()), axis=-1).values
    assert q[0, 1:9].tolist() == [2, -4, 0, 0, 6, 6, -126, 2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_bit_exact(dtype):
    x = _data(2, (8, 24))
    jqt = jq.quantize_int8(jnp.asarray(x), axis=0)
    tqt = tq.quantize_int8(torch.from_numpy(x), axis=0)
    jd = np.asarray(jq.dequantize(jqt, jnp.dtype(dtype)).astype(jnp.float32))
    td = tq.dequantize(tqt, getattr(torch, dtype)).to(torch.float32).numpy()
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("K,N", [(64, 48), (896, 128), (4864, 32)])
def test_int8_matmul_bit_exact(K, N):
    rng = np.random.default_rng(K)
    x = rng.standard_normal((5, K)).astype(np.float32)
    x[1] = 0.0
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    jw = jq.quantize_int8(jnp.asarray(w), axis=0)
    tw = tq.quantize_int8(torch.from_numpy(w), axis=0)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jw,
                                     out_dtype=jnp.float32))
    got = tq.int8_matmul(torch.from_numpy(x), tw,
                         out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_bit_exact(seed):
    kv = _data(seed, (2, 3, 7, 32))
    kv[1, 2, 3] = 0.0                            # reset-slot style zero row
    jv, js = jq.quantize_kv(jnp.asarray(kv))
    tv, ts = tq.quantize_kv(torch.from_numpy(kv))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 2, 3, 0].item() == 1.0 and ts[0, 0, 0, 0].item() == 1.0
    for dt in ("float32", "bfloat16"):
        jd = jq.dequantize_kv(jv, js, jnp.dtype(dt)).astype(jnp.float32)
        td = tq.dequantize_kv(tv, ts, getattr(torch, dt)).to(torch.float32)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_quantize_kv_ties():
    tv, ts = tq.quantize_kv(torch.from_numpy(_ties()))
    jv, js = jq.quantize_kv(jnp.asarray(_ties()))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
