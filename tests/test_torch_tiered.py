"""Tiered KV cache of the port against the JAX reference, in float32.

- the int4 quantizer (pack, unpack, quantize, dequantize) is bit-exact,
  zero rows, ±7 clipping and half-way ties included;
- every tiered cache operation (append, chunk write with a wrapping ring
  residue and ``valid < C``, the resolved read and its shard views, the
  chunk program's hot image, the slot's cold image and the swap pair)
  gives byte-identical caches and images for bf16 (verbatim), int8 and
  int4 cold tiers, fed the same arrays on both sides;
- ``chunk_attention_tiered`` is within 1e-5 relative of the reference;
- the model's chunked prefill across a cold boundary and its slotted and
  split-KV decode over a tiered cache agree with the reference's logits
  (the flip-counting rule of ``test_torch_model.py`` for quantized tiers);
- the engine serves token streams, program call counts, host syncs and
  ``stats()["tiered"]`` equal to the JAX engine's for int8 and int4 cold
  at T 1 and 8, a_shards 1 and 2, chunked and monolithic admission; a
  bf16 cold tier serves the flat cache's streams; preempt-then-restore
  (int4 under a_shards=2 included), same-slot re-admission after demotion
  and a byte budget that preempts are token-identical to uninterrupted
  serves; and the tier validation errors are the reference's.

No test reads a wall clock. Split-KV decode in bf16 does not run on this
jax CPU build, so every comparison with JAX runs float32 configs
(``HOT=4, BLOCK=4``: hot ring of 8, boundary every 4 tokens; extent 32).
"""
import re

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import repro.kv.cache as jcache                              # noqa: E402
import repro.quant.int4 as jint4                             # noqa: E402
import repro_torch.kv.cache as tcache                        # noqa: E402
from repro.configs.registry import ASSIGNED                  # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.models.attention import (                         # noqa: E402
    chunk_attention_tiered as jax_chunk_attention_tiered)
from repro.quant.int8 import QuantizedTensor as JaxQT        # noqa: E402
from repro.runtime.serving import KVArbiter as JaxArbiter    # noqa: E402
from repro.runtime.serving import Request as JaxRequest      # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.interop import (kv_cache_from_numpy,        # noqa: E402
                                 params_from_numpy)
from repro_torch.models.attention import chunk_attention_tiered  # noqa
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.quant import int4 as tint4                  # noqa: E402
from repro_torch.runtime.serving import (KVArbiter, Request,  # noqa: E402
                                         ServingEngine)

torch.set_num_threads(2)

PROMPT_LEN = 8
CAP = 24                     # KV extent 32: divides by a_shards 1 and 2
HOT, BLOCK = 4, 4            # hot ring H = 8; the boundary moves every 4
COLDS = ["bfloat16", "int8", "int4"]
ATOL = 1e-5                  # relative to max(1, max|reference|)
LOGIT_RTOL = 1e-4            # model logits, no quantized byte differs
FLIP_RTOL = 2e-2             # once a stored int8/int4 step differs


def to_numpy_tree(tree):
    if isinstance(tree, JaxQT):
        return {"values": np.asarray(tree.values),
                "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree))


def _over(cold=None):
    over = dict(dtype="float32")
    if cold is not None:
        over.update(hot_window=HOT, kv_cold_dtype=cold, kv_cold_block=BLOCK)
    return over


@pytest.fixture(scope="module")
def models():
    """``models(cold)`` -> (jcfg, japi, jparams, tapi, tparams) on the same
    seeded weights, built once per cold dtype (None: the flat cache)."""
    built = {}

    def get(cold=None):
        if cold not in built:
            jcfg = ASSIGNED["qwen2-0.5b"].reduced().replace(**_over(cold))
            tcfg = get_config("qwen2-0.5b").reduced().replace(**_over(cold))
            japi = jax_build_model(jcfg)
            jparams = japi.init(jax.random.key(0))
            tapi = build_model(tcfg, device="cpu")
            tparams = params_from_numpy(to_numpy_tree(jparams), tcfg,
                                        device="cpu")
            built[cold] = (jcfg, japi, jparams, tapi, tparams)
        return built[cold]

    return get


def assert_bytes_equal(got, want, what=""):
    """Tuples of port tensors and JAX arrays (None where a buffer is
    absent) hold the same bytes."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), (what, i)
        if g is not None:
            w = np.asarray(w)
            assert g.dtype == torch.from_numpy(w[:0].copy()).dtype, (what, i)
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{what} buffer {i}")


def assert_close(got, want, tol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


# ---------------------------------------------------------------------------
# int4 quantizer
# ---------------------------------------------------------------------------

def _int4_inputs(case):
    rng = np.random.default_rng(0)
    if case == "random":
        return rng.standard_normal((3, 5, 16)).astype(np.float32)
    if case == "zero_rows":
        x = rng.standard_normal((4, 16)).astype(np.float32)
        x[1] = 0.0
        x[3] = 0.0
        return x
    if case == "clip":
        # one huge element per row: every other element rounds to 0, the
        # maximum to +-7 exactly; the negative row tests the -7 clip
        x = rng.uniform(-1, 1, (2, 16)).astype(np.float32)
        x[0, 3], x[1, 9] = 1e6, -1e6
        return x
    # half-way ties: amax 7 gives scale 1.0, so x.5 rounds half to even
    x = np.array([[7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                   -3.5, 4.5, 5.5, -6.5, 6.49, 0.0, -7.0, 6.5]], np.float32)
    return x


@pytest.mark.parametrize("case", ["random", "zero_rows", "clip", "ties"])
def test_int4_quantizer_bit_exact(case):
    x = _int4_inputs(case)
    jq, js = jint4.quantize_kv_int4(jnp.asarray(x))
    tq, ts = tint4.quantize_kv_int4(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tq.shape[-1] == x.shape[-1] // 2
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = tint4.dequantize_kv_int4(tq, ts, dt).float().numpy()
        want = np.asarray(jint4.dequantize_kv_int4(jq, js, jdt)
                          .astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
    if case == "zero_rows":
        assert not tint4.dequantize_kv_int4(tq, ts, torch.float32)[1].any()
        assert float(ts[1, 0]) == 1.0
    if case == "ties":
        np.testing.assert_array_equal(
            tint4.unpack_int4(tq).numpy()[0],
            [7, 0, 2, 2, 0, -2, -2, 4, -4, 4, 6, -6, 6, 0, -7, 6])


def test_int4_pack_unpack_bit_exact():
    """Every nibble value in both halves of a byte packs and unpacks as
    the reference's; odd lengths raise."""
    vals = np.arange(-8, 8, dtype=np.int8)
    q = np.stack(np.meshgrid(vals, vals), -1).reshape(-1, 16 * 2)
    packed = tint4.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jint4.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tint4.unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(
        tint4.unpack_int4(packed).numpy(),
        np.asarray(jint4.unpack_int4(jnp.asarray(packed.numpy()))))
    with pytest.raises(ValueError, match="even"):
        tint4.pack_int4(torch.zeros(1, 3, dtype=torch.int8))


# ---------------------------------------------------------------------------
# cache operations on the same arrays
# ---------------------------------------------------------------------------

def _fill(a, rng):
    """Random bytes for a JAX buffer of the tiered cache (numpy)."""
    if a is None:
        return None
    if a.dtype == jnp.int8:
        return rng.integers(-128, 128, a.shape).astype(np.int8)
    if a.shape[-1] == 1:                                 # scales
        return rng.uniform(0.01, 1.0, a.shape).astype(np.float32)
    return rng.standard_normal(a.shape).astype(np.float32)


def _cache_pair(cold, L=1, B=2, n_kv=2, S=24, hd=8, seed=0):
    """One JAX tiered cache filled with random bytes and the port's copy
    (from ``kv_cache_from_numpy``)."""
    jc = jcache.init_kv_cache(L, B, n_kv, S, hd, dtype=jnp.float32,
                              hot_window=HOT, cold_block=BLOCK,
                              cold_dtype=cold)
    rng = np.random.default_rng(seed)
    tree = {f: _fill(getattr(jc, f), rng) for f in
            ("k", "v", "k_scale", "v_scale", "hot_k", "hot_v")}
    tree["length"] = np.int32(0)
    jc = jc._replace(**{f: None if a is None else jnp.asarray(a)
                        for f, a in tree.items() if f != "length"})
    cfg = get_config("qwen2-0.5b").reduced().replace(**_over(cold))
    return jc, kv_cache_from_numpy(tree, cfg, device="cpu")


def _buffers(c):
    return (c.k, c.v, c.k_scale, c.v_scale, c.hot_k, c.hot_v)


def _jlayer(jc, i=0):
    return tuple(None if a is None else a[i] for a in _buffers(jc))


@pytest.mark.parametrize("cold", COLDS)
def test_init_and_geometry_match_reference(cold):
    jc = jcache.init_kv_cache(2, 3, 2, 24, 8, dtype=jnp.float32,
                              hot_window=HOT, cold_block=BLOCK,
                              cold_dtype=cold)
    tc = tcache.init_kv_cache(2, 3, 2, 24, 8, dtype=torch.float32,
                              hot_window=HOT, cold_block=BLOCK,
                              cold_dtype=cold)
    assert tc.is_tiered and not tcache.init_kv_cache(
        1, 1, 2, 8, 8, dtype=torch.float32).is_tiered
    assert (tc.hot_window, tc.cold_block, tc.cold_dtype) == \
        (jc.hot_window, jc.cold_block, jc.cold_dtype)
    assert_bytes_equal(_buffers(tc), _buffers(jc), "init")
    assert len(tc.layer(1)) == 6
    assert tcache.hot_extent(HOT, BLOCK) == jcache.hot_extent(HOT, BLOCK)
    counts = np.arange(0, 40, dtype=np.int32)
    for hot, block in ((HOT, BLOCK), (64, 16), (32, 16), (0, 3)):
        np.testing.assert_array_equal(
            tcache.cold_boundary(torch.from_numpy(counts), hot, block)
            .numpy(), np.asarray(jcache.cold_boundary(counts, hot, block)))


@pytest.mark.parametrize("cold", COLDS)
def test_append_and_resolved_read_match_reference(cold):
    """Decode appends at ragged cursors (one row pauses, the ring wraps
    twice), then the resolved image over every bucket and shard cut."""
    jc, tc = _cache_pair(cold, seed=1)
    jl, tl = list(_jlayer(jc)), list(tc.layer(0))
    rng = np.random.default_rng(2)
    B, n_kv, _, hd = jl[4].shape
    starts = np.array([0, 5], np.int32)
    # eager on the JAX side: under jit XLA may turn the scale's division by
    # a constant into a multiply, one ulp away from the eager result
    for t in range(19):
        k_new = rng.standard_normal((B, n_kv, hd)).astype(np.float32)
        v_new = rng.standard_normal((B, n_kv, hd)).astype(np.float32)
        pos = starts + t
        active = np.array([True, t % 5 != 3])
        jl = list(jcache.layer_append_tiered(
            *jl, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos),
            cold, jnp.asarray(active)))
        tcache.layer_append_tiered(*tl, torch.from_numpy(k_new),
                                   torch.from_numpy(v_new),
                                   torch.from_numpy(pos), cold,
                                   torch.from_numpy(active))
    assert_bytes_equal(tl, jl, f"append {cold}")
    assert_bytes_equal(_buffers(tc), [a if a is None else a[None]
                                      for a in jl], "in place")
    counts = np.array([19, 21], np.int32)
    geom = (HOT, BLOCK, cold)
    for bucket in (0, 8, 16, 24):
        want = jcache.layer_read_tiered(*jl, jnp.asarray(counts), bucket,
                                        *geom, dtype=jnp.float32)
        got = tcache.layer_read_tiered(*tl, torch.from_numpy(counts),
                                       bucket, *geom, dtype=torch.float32)
        assert_bytes_equal(got, want, f"read bucket {bucket}")
        for n in (1, 2, 4):
            want = jcache.layer_read_tiered_shards(
                *jl, jnp.asarray(counts), bucket, n, *geom,
                dtype=jnp.float32)
            got = tcache.layer_read_tiered_shards(
                *tl, torch.from_numpy(counts), bucket, n, *geom,
                dtype=torch.float32)
            assert_bytes_equal(got, want, f"shards {n} bucket {bucket}")


# (start, valid_len, C) on extent 24 and ring 8: a 12-wide chunk wraps the
# ring, valid < C leaves ring slots and cold positions untouched, an odd
# start offsets the residue, the last window ends on the extent
CHUNKS = [(0, 12, 12), (3, 5, 12), (13, 7, 8), (16, 8, 8), (5, 1, 4)]


@pytest.mark.parametrize("cold", COLDS)
@pytest.mark.parametrize("start,valid,C", CHUNKS)
def test_chunk_write_and_images_match_reference(cold, start, valid, C):
    jc, tc = _cache_pair(cold, seed=3)
    jl, tl = _jlayer(jc), tc.layer(0)
    rng = np.random.default_rng(4)
    n_kv, hd = jl[4].shape[1], jl[4].shape[3]
    k_new = rng.standard_normal((n_kv, C, hd)).astype(np.float32)
    v_new = rng.standard_normal((n_kv, C, hd)).astype(np.float32)
    slot, S = 1, jl[0].shape[2]
    want_img = jcache.chunk_hot_image(jl[4], jl[5], jnp.asarray(k_new),
                                      jnp.asarray(v_new), slot, start, valid,
                                      S, dtype=jnp.float32)
    got_img = tcache.chunk_hot_image(tl[4], tl[5], torch.from_numpy(k_new),
                                     torch.from_numpy(v_new), slot, start,
                                     valid, S, dtype=torch.float32)
    assert_bytes_equal(got_img, want_img, "hot image")
    before = [None if a is None else a.clone() for a in tl]
    jl = jcache.layer_write_chunk_tiered(*jl, jnp.asarray(k_new),
                                         jnp.asarray(v_new), slot, start,
                                         valid, cold)
    tcache.layer_write_chunk_tiered(*tl, torch.from_numpy(k_new),
                                    torch.from_numpy(v_new), slot, start,
                                    valid, cold)
    assert_bytes_equal(tl, jl, f"chunk write {cold}")
    # slot 0 keeps every byte; positions past the valid window too
    for a, b in zip(tl, before):
        if a is not None:
            assert torch.equal(a[0], b[0])
    assert torch.equal(tl[0][1, :, start + valid:],
                       before[0][1, :, start + valid:])
    want = jcache.layer_read_slot_cold(*jl[:4], slot, cold,
                                       dtype=jnp.float32)
    got = tcache.layer_read_slot_cold(*tl[:4], slot, cold,
                                      dtype=torch.float32)
    assert_bytes_equal(got, want, "slot cold image")


def test_chunk_window_past_the_extent_raises():
    _, tc = _cache_pair("int8")
    tl = tc.layer(0)
    new = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="does not fit"):
        tcache.chunk_hot_image(tl[4], tl[5], new, new, 0, 20, 4, 24)
    with pytest.raises(ValueError, match="does not fit"):
        tcache.layer_write_chunk_tiered(*tl, new, new, 0, 20, 4, "int8")


@pytest.mark.parametrize("cold", COLDS)
def test_swap_pair_matches_reference(cold):
    """Export one slot of a 2-layer, 3-slot cache (a copy), zero the slot,
    import at valid_len 1, 11 and the full extent: the cold tier is masked
    to valid_len, the ring restores verbatim at full width, neighbours
    keep every byte; all of it equals the reference."""
    jc, tc = _cache_pair(cold, L=2, B=3, seed=5)
    saved = tcache.export_slot_kv(tc, 1)
    jsaved = jcache.export_slot_kv(jc, 1)
    assert_bytes_equal(saved, jsaved, "export")
    assert saved[4] is not None and saved[4].data_ptr() != \
        tc.hot_k.data_ptr()
    for valid in (1, 11, 24):
        jz = jcache.reset_slot(jc, 1)
        tz = tcache.reset_slot(_cache_pair(cold, L=2, B=3, seed=5)[1], 1)
        assert_bytes_equal(_buffers(tz), _buffers(jz), "reset")
        jb = jcache.import_slot_kv(jz, jsaved, 1, valid)
        tb = tcache.import_slot_kv(tz, saved, 1, valid)
        assert_bytes_equal(_buffers(tb), _buffers(jb), f"import {valid}")
        assert int(tb.length) == int(jb.length)
        for t in (tb.hot_k, tb.hot_v):
            assert t[:, 1].any()
        assert not tb.k[:, 1, :, valid:].any()
    flat = tcache.init_kv_cache(2, 3, 2, 24, 8, dtype=torch.float32)
    with pytest.raises(ValueError, match="tiered"):
        tcache.import_slot_kv(flat, saved, 0, 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_attention_tiered_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B, C, Hq, n_kv, S, hd = 1, 6, 4, 2, 24, 16
    q = rng.standard_normal((B, C, Hq, hd)).astype(np.float32)
    kh, vh, kc, vc = (rng.standard_normal((B, n_kv, S, hd))
                      .astype(np.float32) for _ in range(4))
    pos = 9 + np.arange(C)
    mask = np.arange(S)[None, :] <= pos[:, None]
    hot = (np.arange(S)[None, :] >= np.asarray(
        jcache.cold_boundary(pos + 1, HOT, BLOCK))[:, None])[None]
    want = jax_chunk_attention_tiered(
        *(jnp.asarray(a) for a in (q, kh, vh, kc, vc, hot, mask)), NULL_CTX)
    got = chunk_attention_tiered(*(torch.from_numpy(a) for a in
                                   (q, kh, vh, kc, vc, hot, mask)))
    assert_close(got.numpy(), np.asarray(want))


def test_init_errors_match_reference():
    cases = [dict(quantized=True, hot_window=4, cold_block=4,
                  cold_dtype="int8"),
             dict(hot_window=4, cold_block=0, cold_dtype="int8"),
             dict(hot_window=4, cold_block=4, cold_dtype="fp8")]
    for kw in cases:
        with pytest.raises(ValueError) as e:
            jcache.init_kv_cache(1, 1, 2, 16, 8, **kw)
        with pytest.raises(ValueError, match=re.escape(str(e.value))):
            tcache.init_kv_cache(1, 1, 2, 16, 8, **kw)
    with pytest.raises(ValueError) as e:
        jcache.init_kv_cache(1, 1, 2, 16, 7, hot_window=4, cold_block=4,
                             cold_dtype="int4")
    with pytest.raises(ValueError, match=re.escape(str(e.value))):
        tcache.init_kv_cache(1, 1, 2, 16, 7, hot_window=4, cold_block=4,
                             cold_dtype="int4")


# ---------------------------------------------------------------------------
# the model over a tiered cache
# ---------------------------------------------------------------------------

def _cold_flips(jc, tc) -> int:
    """Stored cold-tier steps that differ (int8 bytes, int4 nibbles); each
    must be one step. 0 for a verbatim (float) cold tier."""
    if tc.k_scale is None:
        return 0
    n = 0
    for j, t in ((jc.k, tc.k), (jc.v, tc.v)):
        j = torch.from_numpy(np.array(j))
        if tc.cold_dtype == "int4":
            j, t = tint4.unpack_int4(j), tint4.unpack_int4(t)
        d = (t.to(torch.int32) - j.to(torch.int32)).abs()
        assert int(d.max()) <= 1
        n += int((d > 0).sum())
    assert n <= 1e-3 * 2 * tc.k.numel(), n
    return n


def _rtol(jc, tc):
    return LOGIT_RTOL if _cold_flips(jc, tc) == 0 else FLIP_RTOL


@pytest.mark.parametrize("cold", COLDS)
def test_model_chunked_prefill_and_decode_match_reference(models, cold):
    """Two slots prefilled by 3-wide chunks (11 and 6 tokens: slot 0's
    chunks cross the cold boundary at 4 and 8), then 4 slotted decode
    steps at ragged cursors, over bucket 16 sequentially and over the full
    extent split into 2 shards in turn, all in place on one cache per
    side."""
    jcfg, japi, jparams, tapi, tparams = models(cold)
    j_chunk = jax.jit(lambda p, c, t, s, st, v: japi.prefill_chunk(
        p, c, t, s, st, v, NULL_CTX))
    j_decode = jax.jit(lambda p, c, t, pos, a, kv_bucket, kv_shards:
                       japi.decode_slotted(p, c, t, pos, a, NULL_CTX,
                                           kv_bucket=kv_bucket,
                                           kv_shards=kv_shards),
                       static_argnames=("kv_bucket", "kv_shards"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n, dtype=np.int32)
               for n in (11, 6)]
    jc = japi.init_caches(2, 32)
    tc = tapi.init_caches(2, 32)
    first = []
    for slot, p in enumerate(prompts):
        for start in range(0, len(p), 3):
            valid = min(3, len(p) - start)
            row = np.zeros((1, 3), np.int32)
            row[0, :valid] = p[start:start + valid]
            jc, jl = j_chunk(jparams, jc, jnp.asarray(row), slot, start,
                             valid)
            tc, tl = tapi.prefill_chunk(tparams, tc, torch.from_numpy(row),
                                        slot, start, valid)
            want = np.asarray(jl)
            err = np.abs(tl.numpy() - want).max()
            assert err <= _rtol(jc, tc) * np.abs(want).max(), (slot, start)
        first.append(int(want[0, -1].argmax()))
    tok = np.array(first, np.int32)
    pos = np.array([11, 6], np.int32)
    active = np.ones(2, bool)
    for step in range(4):
        bucket, shards = (16, 1) if step % 2 == 0 else (32, 2)
        jc, jl = j_decode(jparams, jc, jnp.asarray(tok), jnp.asarray(pos),
                          jnp.asarray(active), kv_bucket=bucket,
                          kv_shards=shards)
        tc, tl = tapi.decode_slotted(tparams, tc, torch.from_numpy(tok),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(active),
                                     kv_bucket=bucket, kv_shards=shards)
        want = np.asarray(jl)
        err = np.abs(tl.numpy() - want).max()
        assert err <= _rtol(jc, tc) * np.abs(want).max(), (step, err)
        nxt = want[:, 0].argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl[:, 0].argmax(-1).numpy(), nxt)
        tok, pos = nxt, pos + 1
    for name in ("hot_k", "hot_v"):
        assert_close(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                     1e-4)


def test_write_prefill_refuses_tiered_cache(models):
    _, _, _, tapi, tparams = models("int8")
    with pytest.raises(ValueError, match="tiered"):
        tapi.prefill(tparams, torch.zeros(1, 4, dtype=torch.int64))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _plan(cls, vocab, seed=0, new=(20, 12, 8)):
    """Staggered arrivals over 2 slots; the longest request crosses the
    cold boundary several times (prompt 8 + 20 tokens, boundary up to 24)."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, PROMPT_LEN,
                                            dtype=np.int32),
                max_new_tokens=n, arrival_step=4 * i)
            for i, n in enumerate(new)]


def _kw(T=8, chunk=4, a_shards=1, **kw):
    return dict(mode="continuous", max_new_cap=CAP, block_size=T,
                kv_bucket_chunk=16 if T > 1 else 0, prefill_chunk=chunk,
                a_shards=a_shards, **kw)


def _serve_jax(models, cold, plan, slots=2, **kw):
    jcfg, japi, jparams, _, _ = models(cold)
    reqs = plan(JaxRequest, jcfg.vocab_size)
    eng = JaxEngine(japi, NULL_CTX, slots, PROMPT_LEN, **_kw(**kw))
    return reqs, eng.run(jparams, reqs, max_steps=1500), eng


def _serve_port(models, cold, plan, slots=2, **kw):
    _, _, _, tapi, tparams = models(cold)
    reqs = plan(Request, tapi.config.vocab_size)
    eng = ServingEngine(tapi, slots, PROMPT_LEN, device="cpu", **_kw(**kw))
    return reqs, eng.run(tparams, reqs, max_steps=1500), eng


def _streams(reqs):
    return {r.rid: list(r.generated) for r in reqs}


def assert_engines_agree(jout, tout):
    (jreqs, jstats, jeng), (treqs, tstats, teng) = jout, tout
    assert _streams(treqs) == _streams(jreqs)
    assert [r.admit_step for r in treqs] == [r.admit_step for r in jreqs]
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert teng.host_syncs == jeng.host_syncs
    for key in ("completed", "decode_steps", "macro_steps", "decode_tokens",
                "prefill_chunks", "prefill_mode", "preemptions", "restores"):
        assert tstats[key] == jstats[key], key
    jrt, trt = jstats["runtime"], tstats["runtime"]
    assert set(trt) == set(jrt)
    for prog in trt:
        assert trt[prog]["calls"] == jrt[prog]["calls"], prog
        assert trt[prog]["compiles"] == 1, prog
    assert tstats["tiered"] == jstats["tiered"]


LANES = {
    # name: (block_size, prefill_chunk, a_shards); every pair of values of
    # two of the three knobs meets in one lane
    "t8_chunk": (8, 4, 1),
    "t1_chunk_split2": (1, 4, 2),
    "t8_mono_split2": (8, 0, 2),
    "t1_mono": (1, 0, 1),
}


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("cold", ["int8", "int4"])
def test_engine_matches_reference(models, cold, lane):
    T, chunk, a = LANES[lane]
    kw = dict(T=T, chunk=chunk, a_shards=a)
    jout = _serve_jax(models, cold, _plan, **kw)
    tout = _serve_port(models, cold, _plan, **kw)
    assert_engines_agree(jout, tout)
    stats = tout[1]
    assert stats["completed"] == 3
    assert stats["tiered"]["demotions"] > 0
    assert stats["tiered"]["cold_dtype"] == cold
    if not chunk:
        # monolithic tiered admission is the full-width chunk program
        assert "serve_prefill1" not in stats["runtime"]
        assert stats["runtime"]["serve_admit"]["calls"] == 3


@pytest.mark.parametrize("kw", [dict(T=8, chunk=4), dict(T=1, chunk=4),
                                dict(T=8, chunk=0)],
                         ids=["t8_chunk", "t1_chunk", "t8_mono"])
def test_bf16_cold_streams_equal_flat(models, kw):
    """A verbatim cold tier is a relayout: the port's streams equal its
    flat cache's, through the chunk lane and the full-width monolithic
    admission."""
    ref, _, _ = _serve_port(models, None, _plan, **kw)
    got, stats, _ = _serve_port(models, "bfloat16", _plan, **kw)
    assert _streams(got) == _streams(ref)
    assert stats["tiered"]["demotions"] > 0


def _preempt_plan(cls, vocab, seed=3):
    rng = np.random.default_rng(seed)
    rs = [cls(rid=i, prompt=rng.integers(0, vocab, PROMPT_LEN,
                                         dtype=np.int32),
              max_new_tokens=20, arrival_step=0, priority=0)
          for i in range(2)]
    rs.append(cls(rid=2, prompt=rng.integers(0, vocab, 6, dtype=np.int32),
                  max_new_tokens=6, arrival_step=8, priority=5))
    return rs


@pytest.mark.parametrize("cold,a_shards", [("int8", 1), ("int4", 2)])
def test_preempt_restore_token_identical(models, cold, a_shards):
    """Victims export both tiers; the restore resumes with the cold prefix
    and the ring bit-identical: 20-token decoders cross the boundary
    before and after the preemption. Equal to the uninterrupted serve and
    to the JAX engine's preemptible serve (stats["tiered"] included)."""
    base, _, _ = _serve_port(models, cold, _preempt_plan, slots=3,
                             a_shards=a_shards)
    ref = _streams(base)
    assert all(ref.values())
    kw = dict(slots=2, a_shards=a_shards, preemptible=True,
              strict_invariants=True)
    tout = _serve_port(models, cold, _preempt_plan, **kw)
    stats = tout[1]
    assert stats["preemptions"] >= 1 and stats["restores"] >= 1
    assert _streams(tout[0]) == ref
    assert stats["tiered"]["demotions"] > 0
    assert_engines_agree(_serve_jax(models, cold, _preempt_plan, **kw), tout)


def test_same_slot_readmission_after_demotion(models):
    """One slot: rid 0 demotes past the boundary, is preempted for a
    high-priority arrival and re-admitted into the SAME slot over the
    arrival's bytes in both tiers; its tokens equal the uninterrupted
    serve's."""
    def plan(cls, vocab):
        rng = np.random.default_rng(7)
        return [cls(rid=0, prompt=rng.integers(0, vocab, PROMPT_LEN,
                                               dtype=np.int32),
                    max_new_tokens=18, arrival_step=0, priority=0),
                cls(rid=1, prompt=rng.integers(0, vocab, 5, dtype=np.int32),
                    max_new_tokens=5, arrival_step=6, priority=3)]

    base, _, _ = _serve_port(models, "int8", plan)
    test, stats, _ = _serve_port(models, "int8", plan, slots=1,
                                 preemptible=True, strict_invariants=True)
    assert stats["preemptions"] == 1 and stats["restores"] == 1
    assert _streams(test) == _streams(base)
    assert all(r.status == "completed" for r in test)


def test_kv_budget_preempts_under_pressure(models):
    """A byte budget below two busy slots' occupancy makes the arbiter
    preempt; every request completes with the unbudgeted streams, and the
    run equals the JAX engine's under the same budget."""
    base, _, _ = _serve_port(models, "int8", _plan, preemptible=True)
    _, _, _, tapi, _ = models("int8")
    budget = KVArbiter(tapi.init_caches(2, PROMPT_LEN + CAP,
                                        device="meta")).hot_bytes_per_token * 8
    kw = dict(preemptible=True, kv_budget_bytes=budget)
    tout = _serve_port(models, "int8", _plan, **kw)
    reqs, stats, _ = tout
    assert stats["preemptions"] >= 1, "budget pressure never preempted"
    assert all(r.status == "completed" for r in reqs)
    assert _streams(reqs) == _streams(base)
    assert stats["tiered"]["kv_budget_bytes"] == budget
    assert_engines_agree(_serve_jax(models, "int8", _plan, **kw), tout)


def test_arbiter_accounting_matches_reference(models):
    """The port's arbiter and the reference's, driven through the same
    observations, releases and seeds, report equal stats at every step;
    the byte model reads off a ``meta`` cache."""
    _, japi, _, tapi, _ = models("int8")
    jarb = JaxArbiter(jax.eval_shape(
        lambda: japi.init_caches(2, PROMPT_LEN + CAP)))
    tarb = KVArbiter(tapi.init_caches(2, PROMPT_LEN + CAP, device="meta"))
    assert tarb.kv_bytes_per_slot == jarb.kv_bytes_per_slot > 0
    assert tarb.cold_bytes_per_token < tarb.hot_bytes_per_token
    ops = [("observe", 0, 6), ("observe", 0, 20), ("observe", 0, 20),
           ("observe", 1, 10), ("budget", None, -1), ("release", 1, None),
           ("release", 0, None), ("seed", 0, 20), ("observe", 0, 24),
           ("observe", 1, 31)]
    for op, slot, arg in ops:
        for arb in (jarb, tarb):
            if op == "budget":
                arb.budget = arb.live_bytes() - 1
            elif op == "release":
                arb.release(slot)
            else:
                getattr(arb, op)(slot, arg)
        assert tarb.stats() == jarb.stats(), (op, slot, arg)
        assert tarb.over_budget() == jarb.over_budget()
        for s in (0, 1):
            assert tarb.slot_occupancy(s) == jarb.slot_occupancy(s)
    assert tarb.demotions == 12
    with pytest.raises(ValueError, match="tiered"):
        KVArbiter(build_model(get_config("qwen2-0.5b").reduced(),
                              device="cpu").init_caches(2, 8, device="meta"))


def test_tier_validation_errors_match_reference(models):
    jcfg, japi, _, tapi, _ = models("int8")
    jflat, tflat = models(None)[1], models(None)[3]
    cases = [(japi, tapi, dict(mode="drain")),
             (jflat, tflat, dict(kv_budget_bytes=1 << 20)),
             (japi, tapi, dict(kv_budget_bytes=-1))]
    for ja, ta, kw in cases:
        with pytest.raises(ValueError) as e:
            JaxEngine(ja, NULL_CTX, 2, PROMPT_LEN, max_new_cap=CAP, **kw)
        with pytest.raises(ValueError, match=re.escape(str(e.value))):
            ServingEngine(ta, 2, PROMPT_LEN, device="cpu", max_new_cap=CAP,
                          **kw)
    # a quantized flat cache under tiers: init_kv_cache's error, at
    # engine construction on both sides
    over = dict(kv_dtype="int8")
    japi8 = jax_build_model(jcfg.replace(**over))
    tapi8 = build_model(tapi.config.replace(**over), device="cpu")
    with pytest.raises(ValueError) as e:
        JaxEngine(japi8, NULL_CTX, 2, PROMPT_LEN, max_new_cap=CAP)
    with pytest.raises(ValueError, match=re.escape(str(e.value))):
        ServingEngine(tapi8, 2, PROMPT_LEN, device="cpu", max_new_cap=CAP)
