"""Kernel plain versions against the JAX kernels: each ``ref.py`` of the
port against the Pallas kernel run in interpret mode (as
``tests/test_kernels.py`` runs it) and against the reference's ``ref.py``.
The wrappers run these plain versions for CPU tensors; the CUDA kernels
themselves are held against them on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``). Shapes divide the Pallas blocks, which assert.

Tolerances: f32 math on both sides in a different summation order, so
K1 to 1e-5 and K3 to 1e-4 absolute; K4 bit-exact against the reference
oracle (int32 accumulation), and within 1e-5 relative of the Pallas kernel,
which scales as acc * (x_scale * w_scale) instead of the oracle's
(acc * x_scale) * w_scale.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.kernels.flash_decode.ops import (flash_decode as jax_fd,  # noqa
                                            flash_decode_partial as jax_fdp)
from repro.kernels.flash_decode.ref import flash_decode_ref as jax_fd_ref  # noqa
from repro.kernels.fused_ffn.fused_ffn import fused_ffn_pallas  # noqa: E402
from repro.kernels.fused_ffn.ref import fused_ffn_ref as jax_ffn_ref  # noqa
from repro.kernels.gemv.gemv import gemv_int8_pallas         # noqa: E402
from repro.kernels.gemv.ref import gemv_int8_ref as jax_gemv_ref  # noqa
from repro.quant.int8 import quantize_int8 as jq8, quantize_kv as jqkv  # noqa
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa
from repro_torch.kernels.flash_decode.ops import flash_decode  # noqa: E402
from repro_torch.kernels.flash_decode.ref import NEG_INF     # noqa: E402
from repro_torch.kernels.fused_ffn.ops import fused_ffn      # noqa: E402
from repro_torch.kernels.gemv.ops import gemv_int8_q, gemv_int8_shared  # noqa
from repro_torch.quant.int8 import QuantizedTensor           # noqa: E402

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _fd_inputs(dtype, B=2, Hq=8, n_kv=2, S=256, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    lens = np.array([70, 100] + [S // 2] * (B - 2))[:B]
    mask = np.arange(S)[None, :] < lens[:, None]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.float32}
    jq_, jk, jv = (jnp.asarray(a).astype(jdt[dtype]) for a in (q, k, v))
    ks = vs = None
    if dtype == "int8":
        jk, ks = jqkv(jk)
        jv, vs = jqkv(jv)
    return jq_, jk, jv, ks, vs, jnp.asarray(mask)


def _to_torch(*xs):
    out = []
    for x in xs:
        if x is None:
            out.append(None)
        elif x.dtype == jnp.bfloat16:
            out.append(t(x.astype(jnp.float32)).to(torch.bfloat16))
        else:
            out.append(t(x))
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kv_limit", [None, 100, 64])
def test_flash_decode_plain_matches_pallas_and_ref(dtype, kv_limit):
    q, k, v, ks, vs, mask = _fd_inputs(dtype)
    lim = None if kv_limit is None else jnp.asarray(kv_limit)
    want = np.asarray(jax_fd(q, k, v, mask, ks, vs, interpret=True,
                             block_s=64, kv_limit=lim))
    kf = k if ks is None else k.astype(jnp.float32) * ks
    vf = v if vs is None else v.astype(jnp.float32) * vs
    want_ref = np.asarray(jax_fd_ref(q, kf, vf, mask, kv_limit=lim))
    tq_, tk, tv, tks, tvs, tmask = _to_torch(q, k, v, ks, vs, mask)
    got = flash_decode(tq_, tk, tv, tmask, tks, tvs,
                       kv_limit=kv_limit).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("kv_limit", [100, 0])
def test_flash_decode_partial_stats(dtype, kv_limit):
    """Partial mode equals the Pallas partial kernel; at kv_limit=0 every
    tile is skipped and the result is exactly (0, NEG_INF, 0), as is the
    normalised output 0."""
    q, k, v, ks, vs, mask = _fd_inputs(dtype, seed=1)
    lim = jnp.asarray(kv_limit)
    jo, jm, jl = (np.asarray(a) for a in jax_fdp(
        q, k, v, mask, ks, vs, interpret=True, block_s=64, kv_limit=lim))
    tq_, tk, tv, tks, tvs, tmask = _to_torch(q, k, v, ks, vs, mask)
    o, m, l = flash_decode(tq_, tk, tv, tmask, tks, tvs,
                           kv_limit=torch.tensor(kv_limit, dtype=torch.int32),
                           partial_stats=True)
    np.testing.assert_allclose(o.numpy(), jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), jl, rtol=1e-5, atol=1e-5)
    if kv_limit == 0:
        assert not o.any() and not l.any()
        assert (m == NEG_INF).all()
        norm = flash_decode(tq_, tk, tv, tmask, tks, tvs, kv_limit=0)
        assert not norm.any()


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("B", [1, 8])
def test_fused_ffn_plain_matches_pallas_and_ref(act, B):
    rng = np.random.default_rng(B)
    D, F = 128, 256
    x = rng.standard_normal((B, D)).astype(np.float32)
    wg = rng.standard_normal((D, F)).astype(np.float32) / np.sqrt(D)
    wu = rng.standard_normal((D, F)).astype(np.float32) / np.sqrt(D)
    wd = rng.standard_normal((F, D)).astype(np.float32) / np.sqrt(F)
    jx = [jnp.asarray(a) for a in (x, wg, wu, wd)]
    want = np.asarray(fused_ffn_pallas(*jx, block_f=128, act=act,
                                       interpret=True))
    want_ref = np.asarray(jax_ffn_ref(*jx, act=act))
    got = fused_ffn(t(x), t(wg), t(wu), t(wd), act=act).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("B,K,N", [(1, 256, 256), (8, 512, 384),
                                   (4, 1024, 128)])
def test_gemv_int8_plain_bit_exact(B, K, N):
    rng = np.random.default_rng(K + N)
    x = jnp.asarray(rng.standard_normal((B, K)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((K, N)).astype(np.float32) * 0.05)
    xq, wq = jq8(x, axis=-1), jq8(w, axis=0)
    ws = wq.scale.reshape(1, -1)
    want = np.asarray(jax_gemv_ref(xq.values, xq.scale, wq.values, ws))
    got = gemv_int8_q(t(xq.values), t(xq.scale), t(wq.values), t(ws))
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(gemv_int8_pallas(xq.values, xq.scale, wq.values, ws,
                                         block_n=128, block_k=256,
                                         interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-6)
    # the model-path entry quantizes the rows itself, as repro's ops does
    full, = gemv_int8_shared(t(x), [QuantizedTensor(t(wq.values),
                                                  t(wq.scale))])
    np.testing.assert_array_equal(full.numpy(), want)


def test_wrappers_on_cpu_run_plain_versions_and_count_nothing():
    reset_launch_counts()
    q, k, v, ks, vs, mask = _to_torch(*_fd_inputs("f32"))
    flash_decode(q, k, v, mask)
    fused_ffn(torch.ones(2, 8), torch.ones(8, 16), torch.ones(8, 16),
              torch.ones(16, 8))
    gemv_int8_q(torch.ones(2, 8, dtype=torch.int8), torch.ones(2, 1),
                torch.ones(8, 4, dtype=torch.int8), torch.ones(1, 4))
    assert launch_counts() == {"flash_decode": 0, "fused_ffn": 0,
                               "gemv_int8": 0}


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else that is not
    CUDA raises instead of silently computing somewhere."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_decode(torch.empty(1, 2, 4, **meta),
                     torch.empty(1, 1, 8, 4, **meta),
                     torch.empty(1, 1, 8, 4, **meta),
                     torch.empty(1, 8, dtype=torch.bool, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ffn(torch.empty(2, 8, **meta), torch.empty(8, 16, **meta),
                  torch.empty(8, 16, **meta), torch.empty(16, 8, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        gemv_int8_q(torch.empty(2, 8, dtype=torch.int8, **meta),
                    torch.empty(2, 1, **meta),
                    torch.empty(8, 4, dtype=torch.int8, **meta),
                    torch.empty(1, 4, **meta))
