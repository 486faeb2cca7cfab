"""Kernel plain versions against the JAX kernels: each ``ref.py`` of the
port against the Pallas kernel run in interpret mode (as
``tests/test_kernels.py`` runs it) and against the reference's ``ref.py``.
The wrappers run these plain versions for CPU tensors; the CUDA kernels
themselves are held against them on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``). Shapes divide the Pallas blocks, which assert.

K1's split of S across CTAs is held here in plain form: the port's
``flash_decode_ref`` partial statistics of every tile of ``decode_plan``,
merged in order by the port's ``combine.py``, against the Pallas kernel
(with the kernel's tile as its block) and against the reference's
``combine_partial_stats``; a ragged S, which Pallas refuses, against the
reference's jnp oracle.

Tolerances: f32 math on both sides in a different summation order, so
K1 to 1e-5 (the split walk to 1e-5 * max(1, max|ref|)) and K3 to 1e-4
absolute; K4 bit-exact against the reference
oracle (int32 accumulation), and within 1e-5 relative of the Pallas kernel,
which scales as acc * (x_scale * w_scale) instead of the oracle's
(acc * x_scale) * w_scale.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.kernels.flash_decode.combine import (            # noqa: E402
    combine_partial_stats as jax_combine, merge_partial_stats as jax_merge)
from repro.kernels.flash_decode.ops import (flash_decode as jax_fd,  # noqa
                                            flash_decode_partial as jax_fdp)
from repro.kernels.flash_decode.ref import flash_decode_ref as jax_fd_ref  # noqa
from repro.kernels.flash_decode.ref import (                 # noqa: E402
    flash_decode_ref_partial as jax_fd_ref_partial)
from repro.kernels.fused_ffn.fused_ffn import fused_ffn_pallas  # noqa: E402
from repro.kernels.fused_ffn.ref import fused_ffn_ref as jax_ffn_ref  # noqa
from repro.kernels.gemv.gemv import gemv_int8_pallas         # noqa: E402
from repro.kernels.gemv.ref import gemv_int8_ref as jax_gemv_ref  # noqa
from repro.quant.int8 import quantize_int8 as jq8, quantize_kv as jqkv  # noqa
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa
from repro_torch.kernels.flash_decode.combine import (      # noqa: E402
    combine_partial_stats, merge_partial_stats)
from repro_torch.kernels.flash_decode.ops import (          # noqa: E402
    decode_plan, flash_decode, flash_decode_partial)
from repro_torch.kernels.flash_decode.ref import (          # noqa: E402
    NEG_INF, flash_decode_ref)
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


def _tiles(plan, S):
    """[lo, hi) of every tile K1 walks under ``plan``, split by split."""
    for z in range(plan.splits):
        end = min((z + 1) * plan.split, S)
        for lo in range(z * plan.split, end, plan.tile):
            yield lo, min(lo + plan.tile, end)


def _split_walk(plan, q, k, v, mask, ks, vs, lim):
    """K1's split of S in plain form: the port's partial statistics of
    every tile (kv_limit shifted to the tile, so a tile at or past it is
    the identity), stacked in split and tile order for the merge."""
    S = k.shape[2]
    parts = []
    for lo, hi in _tiles(plan, S):
        sl = (slice(None), slice(None), slice(lo, hi))
        parts.append(flash_decode_ref(
            q, k[sl], v[sl], mask[:, lo:hi],
            None if ks is None else ks[sl], None if vs is None else vs[sl],
            kv_limit=lim - lo, partial_stats=True))
    return tuple(torch.stack(x) for x in zip(*parts))


def _jax_walk(plan, q, k, v, mask, ks, vs, lim):
    """The same walk through the reference's oracle partial statistics."""
    kf = k if ks is None else k.astype(jnp.float32) * ks
    vf = v if vs is None else v.astype(jnp.float32) * vs
    parts = [jax_fd_ref_partial(q, kf[:, :, lo:hi], vf[:, :, lo:hi],
                                mask[:, lo:hi], kv_limit=lim - lo)
             for lo, hi in _tiles(plan, k.shape[2])]
    return tuple(jnp.stack(x) for x in zip(*parts))


def _close(got, want):
    """Within 1e-5 * max(1, max|want|), per tensor."""
    want = np.asarray(want)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


_ISZ = {"f32": 4, "bf16": 2, "int8": 1}


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("split,tile", [(64, None), (128, None), (256, 64)])
@pytest.mark.parametrize("kv_limit", [None, 100, 128, 0, 300])
def test_flash_decode_split_walk_matches_pallas_and_combine(dtype, split,
                                                            tile, kv_limit):
    """S=256 cut by decode_plan into splits of 64 or 128 positions, or one
    split of 256 streamed in ring tiles of 64; kv_limit inside a split, on
    a split edge, 0 and past S; row 0 has no live position at all (the
    walk averages V over the tiles it processed, as the Pallas walk does
    over its blocks)."""
    q, k, v, ks, vs, mask = _fd_inputs(dtype, seed=split)
    mask = mask.at[0].set(False)
    B, Hq, hd = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    plan = decode_plan(B, n_kv, Hq // n_kv, S, hd, _ISZ[dtype], split=split,
                       tile=tile)
    lim = S if kv_limit is None else kv_limit
    jlim = None if kv_limit is None else jnp.asarray(kv_limit)
    want = jax_fd(q, k, v, mask, ks, vs, interpret=True,
                  block_s=plan.tile, kv_limit=jlim)
    want_p = jax_fdp(q, k, v, mask, ks, vs, interpret=True,
                     block_s=plan.tile, kv_limit=jlim)
    jo, jm, jl = _jax_walk(plan, q, k, v, mask, ks, vs, lim)
    tq, tk, tv, tks, tvs, tmask = _to_torch(q, k, v, ks, vs, mask)
    o, m, l = _split_walk(plan, tq, tk, tv, tmask, tks, tvs, lim)
    got = combine_partial_stats(o, m, l)
    _close(got.numpy(), want)
    _close(got.numpy(), jax_combine(jo, jm, jl))
    for a, b, c in zip(merge_partial_stats(o, m, l), want_p,
                       jax_merge(jo, jm, jl)):
        _close(a.numpy(), b)
        _close(a.numpy(), c)
    if lim <= 0:
        assert not got.any()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("S,split", [(17, 16), (200, 48), (200, None)])
@pytest.mark.parametrize("where", ["inside", "edge", "past"])
def test_flash_decode_split_walk_ragged_matches_oracle(dtype, S, split,
                                                       where):
    """A ragged S (no multiple of 16, which Pallas refuses): the walk over
    decode_plan's splits against the reference's jnp oracle, every row live
    below kv_limit."""
    q, k, v, ks, vs, mask = _fd_inputs(dtype, S=S, seed=S)
    B, Hq, hd = q.shape
    n_kv = k.shape[1]
    plan = decode_plan(B, n_kv, Hq // n_kv, S, hd, _ISZ[dtype], split=split)
    lim = {"inside": plan.split // 2 + 3 if plan.splits > 1 else S // 2,
           "edge": plan.split if plan.splits > 1 else S,
           "past": S + 5}[where]
    kf = k if ks is None else k.astype(jnp.float32) * ks
    vf = v if vs is None else v.astype(jnp.float32) * vs
    want = jax_fd_ref(q, kf, vf, mask, kv_limit=jnp.asarray(lim))
    tq, tk, tv, tks, tvs, tmask = _to_torch(q, k, v, ks, vs, mask)
    got = combine_partial_stats(*_split_walk(plan, tq, tk, tv, tmask, tks,
                                             tvs, lim))
    _close(got.numpy(), want)


def test_port_combine_matches_reference_and_identity_merges_exactly():
    """combine.py against the reference's merge on seeded statistics; a
    split skipped whole, (0, NEG_INF, 0), leaves the merge bit-identical."""
    rng = np.random.default_rng(7)
    o = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    m = rng.standard_normal((2, 3, 5)).astype(np.float32) * 4
    l = rng.uniform(1, 9, (2, 3, 5)).astype(np.float32)
    for a, b in zip(merge_partial_stats(t(o), t(m), t(l)),
                    jax_merge(jnp.asarray(o), jnp.asarray(m),
                              jnp.asarray(l))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        combine_partial_stats(t(o), t(m), t(l)).numpy(),
        np.asarray(jax_combine(jnp.asarray(o), jnp.asarray(m),
                               jnp.asarray(l))), rtol=1e-6, atol=1e-6)
    o3 = np.concatenate([o, np.zeros((1, 3, 5, 16), np.float32)])
    m3 = np.concatenate([m, np.full((1, 3, 5), NEG_INF, np.float32)])
    l3 = np.concatenate([l, np.zeros((1, 3, 5), np.float32)])
    for a, b in zip(merge_partial_stats(t(o3), t(m3), t(l3)),
                    merge_partial_stats(t(o), t(m), t(l))):
        assert torch.equal(a, b)


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
    flash_decode_partial(q, k, v, mask)
    fused_ffn(torch.ones(2, 8), torch.ones(8, 16), torch.ones(8, 16),
              torch.ones(16, 8))
    gemv_int8_q(torch.ones(2, 8, dtype=torch.int8), torch.ones(2, 1),
                torch.ones(8, 4, dtype=torch.int8), torch.ones(1, 4))
    assert launch_counts() == {"flash_decode": 0, "flash_decode_partial": 0,
                               "fused_ffn": 0, "gemv_int8": 0}


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
