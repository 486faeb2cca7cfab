"""Split-KV decode of the port against the JAX reference, in float32.

- the shard-local layout helpers (``shard_extent``, ``shard_kv_limits``,
  ``layer_read_shards``) and ``kv_buckets(..., shards)`` equal the
  reference's exactly;
- ``decode_attention_split`` (on the CPU: the plain K1 version in
  partial-statistics mode per shard plus the LSE combine) equals the
  reference's within 1e-5 * max(1, max|reference|) at 1, 2 and 4 shards,
  with ragged lengths, a shard wholly past a row, and both mask forms;
- the engine at ``a_shards`` 2 and 4 serves token streams and host syncs
  identical to the JAX engine's, for dense and int8 KV and T 1 and 8, and
  identical to its own ``a_shards=1`` streams;
- the overlong-prompt left shift stays bit-identical at every shard width,
  and the engine rejects the invalid ``a_shards`` settings the reference
  rejects (colocated backend only: the WA backend is a later slice).

Split-KV decode in bf16 does not run on this jax CPU build (the reference
raises on a bf16 x bf16 = f32 dot), so every comparison with JAX is f32.
"""
import re

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import repro.kv.cache as jcache                              # noqa: E402
from repro.configs.registry import ASSIGNED                  # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.models.attention import (                         # noqa: E402
    decode_attention_split as jax_split,
    decode_attention_split_bucketed as jax_split_bucketed,
    kv_buckets as jax_kv_buckets)
from repro.quant.int8 import QuantizedTensor as JaxQT        # noqa: E402
from repro.runtime.serving import Request as JaxRequest      # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.interop import params_from_numpy            # noqa: E402
from repro_torch.kv.cache import (layer_read_shards,         # noqa: E402
                                  shard_extent, shard_kv_limits, shard_view)
from repro_torch.models.attention import (                   # noqa: E402
    decode_attention_split, decode_attention_split_bucketed, kv_buckets)
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.quant.int8 import quantize_kv               # noqa: E402
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402

torch.set_num_threads(2)

PROMPT_LEN = 8
# true lengths 5/8/11/3: mid-shard ends at every width (extent 40 -> shard
# blocks of 40, 20, 10), one prompt past the static width (chunk lane)
RAGGED = [(6, 0, 5), (6, 0, 8), (6, 2, 11), (6, 4, 3)]
ATOL = 1e-5          # relative to max(1, max|reference|): f32, other order


def to_numpy_tree(tree):
    if isinstance(tree, JaxQT):
        return {"values": np.asarray(tree.values),
                "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree))


def make_models(**over):
    jcfg = ASSIGNED["qwen2-0.5b"].reduced().replace(dtype="float32", **over)
    tcfg = get_config("qwen2-0.5b").reduced().replace(dtype="float32",
                                                      **over)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(to_numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, japi, jparams, tapi, tparams


@pytest.fixture(scope="module", params=["dense", "int8kv"])
def models(request):
    over = {"kv_dtype": "int8"} if request.param == "int8kv" else {}
    return request.param, make_models(**over)


def assert_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= ATOL * max(1.0, np.abs(want).max()), err


# ---------------------------------------------------------------------------
# cache layout helpers and bucket sets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extent,n", [(40, 1), (40, 2), (40, 4), (40, 3),
                                      (200, 4), (192, 4), (40, 0)])
def test_shard_extent_and_limits_match_reference(extent, n):
    try:
        want = jcache.shard_extent(extent, n)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            shard_extent(extent, n)
        return
    assert shard_extent(extent, n) == want
    for lim in (0, 1, want - 1, want, want + 1, extent - 1, extent,
                extent + 7):
        got = shard_kv_limits(torch.tensor(lim, dtype=torch.int32), n, want)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jcache.shard_kv_limits(lim, n, want)))


@pytest.mark.parametrize("s_max", [40, 136, 200])
@pytest.mark.parametrize("chunk", [0, 1, 3, 16, 64, 199, 250])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_kv_buckets_match_reference(s_max, chunk, shards):
    try:
        want = jax_kv_buckets(s_max, chunk, shards)
    except ValueError:
        with pytest.raises(ValueError, match="not divisible"):
            kv_buckets(s_max, chunk, shards)
        return
    assert kv_buckets(s_max, chunk, shards) == want


def _layer(quantized, B=2, n_kv=2, S=40, hd=16, seed=0):
    """One cache layer as numpy (k, v, k_scale, v_scale): f32, or int8 with
    f32 scales quantized by the port's own quantize_kv."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    if not quantized:
        return k, v, None, None
    (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(a)) for a in (k, v))
    return kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("bucket", [0, 16, 40])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_layer_read_shards_matches_reference(quantized, bucket, n):
    arrs = _layer(quantized)
    want = jcache.layer_read_shards(*[_j(a) for a in arrs], bucket, n,
                                    jnp.float32)
    got = layer_read_shards(*[_t(a) for a in arrs], bucket, n,
                            torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the stored-dtype view the kernel route takes: no copy, the cache's
    # own bytes, and shard s is positions [s*Sb, (s+1)*Sb)
    stored = [_t(a) for a in arrs]
    views = shard_view(*stored, bucket, n)
    Sb = (bucket or 40) // n
    for view, base in zip(views, stored):
        if base is None:
            assert view is None
            continue
        assert view.data_ptr() == base.data_ptr()
        assert view.shape[2:4] == (n, Sb)
        for s in range(n):
            assert torch.equal(view[:, :, s], base[:, :, s * Sb:(s + 1) * Sb])
        if base.shape[-1] == 1:
            assert view[:, :, 0].stride(2) == 1      # scales: unit stride


# ---------------------------------------------------------------------------
# attention: per-shard partial statistics + LSE merge
# ---------------------------------------------------------------------------

def _attn_inputs(quantized, seed=0, B=3, Hq=8, n_kv=4, S=96, hd=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k, v, ks, vs = _layer(quantized, B, n_kv, S, hd, seed=seed + 1)
    # row 0 ends mid-shard, row 1 on a shard edge at 2 and 4 shards of 48,
    # row 2 inside shard 0 only (every later shard wholly past it)
    mask = np.arange(S)[None, :] < np.array([[20], [24], [7]])
    return q, k, v, ks, vs, mask


def _dequant(a, s):
    return a if s is None else a.astype(np.float32) * s


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_decode_attention_split_matches_reference(quantized, n):
    q, k, v, ks, vs, mask = _attn_inputs(quantized)
    B, n_kv, S, hd = k.shape
    Sb = S // n
    kd, vd = _dequant(k, ks), _dequant(v, vs)
    jk = jnp.asarray(kd.reshape(B, n_kv, n, Sb, hd))
    jv = jnp.asarray(vd.reshape(B, n_kv, n, Sb, hd))
    want = np.asarray(jax_split(jnp.asarray(q), jk, jv, jnp.asarray(mask),
                                NULL_CTX))
    views = shard_view(*[_t(a) for a in (k, v, ks, vs)], 0, n)
    tq, tmask = torch.from_numpy(q), torch.from_numpy(mask)
    # both mask forms, every position (no limit: every shard computed)
    for m in (tmask, tmask.reshape(B, n, Sb)):
        got = decode_attention_split(tq, views[0], views[1], m, *views[2:])
        assert_close(got.numpy(), want)
    # with the engine's global limit (max live length): shards past it
    # are skipped whole and merge as the exact identity; every row here
    # has a live position, so nothing changes
    lim = torch.tensor(int(mask.sum(1).max()), dtype=torch.int32)
    got = decode_attention_split(tq, views[0], views[1], tmask, *views[2:],
                                 kv_limit=lim)
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("bucket", [0, 48])
def test_decode_attention_split_bucketed_matches_reference(n, bucket):
    q, k, v, _, _, mask = _attn_inputs(False, seed=3)
    want = jax_split_bucketed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), NULL_CTX, n_shards=n,
                              kv_bucket=bucket)
    got = decode_attention_split_bucketed(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), n, kv_bucket=bucket)
    assert_close(got.numpy(), np.asarray(want))


def test_split_rejects_non_dividing_extent():
    q = torch.zeros(1, 4, 16)
    k = v = torch.zeros(1, 2, 40, 16)
    with pytest.raises(ValueError, match="not divisible"):
        decode_attention_split_bucketed(q, k, v, torch.ones(1, 40,
                                                            dtype=torch.bool),
                                        3)


# ---------------------------------------------------------------------------
# engine: split-KV streams == JAX engine == the port's sequential walk
# ---------------------------------------------------------------------------

def _requests(cls, vocab, plan, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, entry in enumerate(plan):
        new, arr, plen = entry if len(entry) == 3 else entry + (PROMPT_LEN,)
        out.append(cls(rid=i, prompt=rng.integers(0, vocab, plen,
                                                   dtype=np.int32),
                       max_new_tokens=new, arrival_step=arr))
    return out


def _kw(T, a_shards, chunk=4):
    return dict(max_new_cap=32, block_size=T,
                kv_bucket_chunk=16 if T > 1 else 0, prefill_chunk=chunk,
                a_shards=a_shards)


def _serve_port(tapi, tparams, plan, T, a_shards, chunk=4):
    reqs = _requests(Request, tapi.config.vocab_size, plan)
    eng = ServingEngine(tapi, 2, PROMPT_LEN, device="cpu",
                        **_kw(T, a_shards, chunk))
    stats = eng.run(tparams, reqs, max_steps=400)
    return reqs, stats, eng


@pytest.fixture(scope="module")
def sequential():
    """The port's own a_shards=1 streams, served once per (config, T)."""
    return {}


@pytest.mark.parametrize("a_shards", [2, 4])
@pytest.mark.parametrize("T", [1, 8])
def test_split_engine_matches_reference_and_sequential(models, sequential,
                                                       T, a_shards):
    name, (jcfg, japi, jparams, tapi, tparams) = models
    jreqs = _requests(JaxRequest, jcfg.vocab_size, RAGGED)
    jeng = JaxEngine(japi, NULL_CTX, 2, PROMPT_LEN, mode="continuous",
                     **_kw(T, a_shards))
    jstats = jeng.run(jparams, jreqs, max_steps=400)
    treqs, tstats, teng = _serve_port(tapi, tparams, RAGGED, T, a_shards)
    assert tstats["completed"] == jstats["completed"] == len(RAGGED)
    assert tstats["a_shards"] == jstats["a_shards"] == a_shards
    for a, b in zip(jreqs, treqs):
        assert b.generated == a.generated, (name, T, a_shards, a.rid)
        assert b.admit_step == a.admit_step
    assert teng.host_syncs == jeng.host_syncs
    for key in ("decode_steps", "macro_steps", "decode_tokens",
                "prefill_chunks"):
        assert tstats[key] == jstats[key], key
    jrt, trt = jstats["runtime"], tstats["runtime"]
    assert set(trt) == set(jrt)
    for prog in trt:
        assert trt[prog]["calls"] == jrt[prog]["calls"], prog
    key = (name, T)
    if key not in sequential:
        sequential[key] = [r.generated for r in
                           _serve_port(tapi, tparams, RAGGED, T, 1)[0]]
    assert [r.generated for r in treqs] == sequential[key]


def test_overlong_prompt_left_shift_is_shard_invariant():
    """A 35-token prompt against extent 40 with chunk 16 forces the last
    window to shift left (start 32 -> 24) and recompute positions 24..34.
    Shards are a read-time view over absolute positions, so streams and
    the prompt KV are bit-identical at every width."""
    _, _, _, tapi, tparams = make_models()
    plan = [(5, 0, 35), (4, 0, 6)]
    streams, caches = {}, {}
    for sh in (1, 2, 4):
        reqs, stats, eng = _serve_port(tapi, tparams, plan, 8, sh, chunk=16)
        assert stats["completed"] == len(plan)
        assert stats["prefill_chunks"] == 3 + 1
        streams[sh] = [list(r.generated) for r in reqs]
        caches[sh] = (eng._caches.k.clone(), eng._caches.v.clone())
    assert streams[1] == streams[2] == streams[4]
    for sh in (2, 4):
        for buf in (0, 1):
            assert torch.equal(caches[sh][buf][:, 0, :, :35],
                               caches[1][buf][:, 0, :, :35])
            assert torch.equal(caches[sh][buf][:, 1, :, :6],
                               caches[1][buf][:, 1, :, :6])


def test_engine_rejects_invalid_a_shards():
    api = build_model(get_config("qwen2-0.5b").reduced(), device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        ServingEngine(api, 2, PROMPT_LEN, device="cpu", a_shards=0)
    # extent 8 + 32 = 40 does not cut into 3 equal shard blocks
    with pytest.raises(ValueError, match="not divisible"):
        ServingEngine(api, 2, PROMPT_LEN, device="cpu", mode="continuous",
                      max_new_cap=32, a_shards=3)
    with pytest.raises(ValueError, match="drain"):
        ServingEngine(api, 2, PROMPT_LEN, device="cpu", mode="drain",
                      a_shards=2)
