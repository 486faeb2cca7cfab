"""The tiered KV cache on a mesh of gloo ranks against the JAX reference on
one device (``NULL_CTX``), the same weights on both sides (the reference's
parameters through ``repro_torch.interop``), reduced qwen2-0.5b in float32
with a hot window of 4 and a cold block of 4 (``torch_mesh_tiered_ranks``):

- the tiered cache functions on a rank's block of a sequence-cut cache
  (the decode append, the resolved read, the chunk write and the chunk
  program's hot image), fed the same arrays, give byte for byte the
  rank's part of what the reference's functions give on the whole cache,
  for int8 and int4 cold tiers and each block of a cut in two and in four
  (no processes);
- on (1, 2) under all three executors and on (2, 1): a chunked admission
  of two slots (11 and 6 tokens, 4 a chunk, crossing cold boundaries) and
  40 teacher-forced decode steps, int8 and int4 cold: each rank's hot
  rings equal its part of the reference's (within f32 rounding of the two
  frameworks' projections: 1e-5 of their largest value), its cold bytes
  are the reference's or one int8 (int4) step off, counted (at most one
  in a thousand), its scales within 1e-5 relative, and the logits of every
  chunk and step within 1e-4 of max|logit| (the repo's flip rule once a
  stored step differs), their argmax equal where the reference's top two
  are apart;
- the engine on the same meshes and executors: token streams, statuses,
  admission steps, host syncs, program calls and ``stats()["tiered"]``
  (demotions, peak bytes, cold bytes saved, per-slot occupancy) equal the
  JAX engine's, unbudgeted (int8, through the chunk lane and, except
  under +seqkv, where the mesh refuses it, by monolithic admission: the
  full-width chunk) and under a byte budget that preempts (int4,
  ``preemptible``), on every rank.

The ranks of each mesh start once (a module fixture), one intra-op thread
each, while the reference runs here. No case reads a wall clock.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import repro.kv.cache as jcache                              # noqa: E402
import repro_torch.kv.cache as tcache                        # noqa: E402
import torch_mesh_tiered_ranks as ranks                      # noqa: E402
from repro.configs.registry import get_config as jget        # noqa: E402
from repro.models import NULL_CTX, build_model as jbuild     # noqa: E402
from repro.models import param_specs as jps                  # noqa: E402
from repro.models import sharding as jsh                     # noqa: E402
from repro.runtime.serving import Request as JRequest        # noqa: E402
from repro.runtime.serving import ServingEngine as JEngine   # noqa: E402
from repro_torch.launch.mesh import launch                   # noqa: E402
from repro_torch.quant.int4 import unpack_int4               # noqa: E402
from test_torch_mesh import to_numpy_tree                    # noqa: E402
from test_torch_mesh_placement import _rules                 # noqa: E402

torch.set_num_threads(1)

COLDS = ("int8", "int4")
LOGIT_RTOL, FLIP_RTOL = 1e-4, 2e-2
HOT_RTOL, SCALE_RTOL = 1e-5, 1e-5
AXES = ("data", "model")


def jcfg(cold=None):
    over = dict(dtype="float32")
    if cold is not None:
        over.update(hot_window=ranks.HOT, kv_cold_dtype=cold,
                    kv_cold_block=ranks.BLOCK)
    return jget(ranks.ARCH).reduced().replace(**over)


# ---------------------------------------------------------------------------
# the reference's local parts
# ---------------------------------------------------------------------------

def _index(entry, coords, shape):
    """(number of parts, this rank's part) along a spec entry."""
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    n, i = 1, 0
    for a in axes:
        n *= shape[a]
        i = i * shape[a] + coords[a]
    return n, i


def local_part(x: np.ndarray, spec, coords, shape) -> np.ndarray:
    for d, e in enumerate(tuple(spec)):
        n, i = _index(e, coords, shape)
        if n > 1:
            c = x.shape[d] // n
            x = np.take(x, range(i * c, (i + 1) * c), axis=d)
    return x


def cache_parts(jc, executor, mesh_shape, coords):
    """{field: this rank's part} of the reference's whole cache under the
    reference's own ``cache_specs``."""
    fake = types.SimpleNamespace(shape=dict(zip(AXES, mesh_shape)))
    ctx = jsh.ShardingCtx(fake, _rules(jsh, executor, False, False))
    specs = jps.cache_specs(jc, ctx)
    shape = dict(zip(AXES, mesh_shape))
    return {f: local_part(np.asarray(getattr(jc, f)), getattr(specs, f),
                          coords, shape)
            for f in ("k", "v", "k_scale", "v_scale", "hot_k", "hot_v")}


def flips(got: np.ndarray, want: np.ndarray, cold: str) -> int:
    """Stored cold steps that differ (int8 bytes, int4 nibbles); each must
    be one step."""
    g, w = torch.from_numpy(got), torch.from_numpy(np.array(want))
    if cold == "int4":
        g, w = unpack_int4(g), unpack_int4(w)
    d = (g.to(torch.int32) - w.to(torch.int32)).abs()
    assert int(d.max()) <= 1
    return int((d > 0).sum())


# ---------------------------------------------------------------------------
# the module's ranks and reference runs
# ---------------------------------------------------------------------------

def ref_cache_run(cold, params, prompts, dec_toks):
    cfg = jcfg(cold)
    api = jbuild(cfg)
    chunk = jax.jit(lambda p, c, t, s, st, v: api.prefill_chunk(
        p, c, t, s, st, v, NULL_CTX))
    decode = jax.jit(lambda p, c, t, pos, a: api.decode_slotted(
        p, c, t, pos, a, NULL_CTX))
    jc = api.init_caches(2, ranks.CACHE_S)
    chunk_logits = {}
    for slot, p in enumerate(prompts):
        for start in range(0, len(p), ranks.CHUNK):
            valid = min(ranks.CHUNK, len(p) - start)
            row = np.zeros((1, ranks.CHUNK), np.int32)
            row[0, :valid] = p[start:start + valid]
            jc, lg = chunk(params, jc, jnp.asarray(row), slot, start, valid)
            chunk_logits[(slot, start)] = np.asarray(lg)[:, -1]
    pos = np.array([len(p) for p in prompts], np.int32)
    act = jnp.ones(2, bool)
    dec = []
    for step in range(dec_toks.shape[0]):
        jc, lg = decode(params, jc, jnp.asarray(dec_toks[step]),
                        jnp.asarray(pos + step), act)
        dec.append(np.asarray(lg)[:, 0])
    return chunk_logits, np.stack(dec), jc


def ref_engine(name, params):
    cold, plan, kw = ranks.engine_kwargs(ranks.TIERED_CASES, name)
    cfg = jcfg(cold)
    reqs = ranks.PLANS[plan](JRequest, cfg.vocab_size)
    eng = JEngine(jbuild(cfg), NULL_CTX, 2, ranks.PROMPT_LEN, **kw)
    st = eng.run(params, reqs, max_steps=1500)
    return {"streams": [list(r.generated) for r in reqs],
            "statuses": [r.status for r in reqs],
            "reasons": [r.reject_reason for r in reqs],
            "preemptions": [r.preemptions for r in reqs],
            "admit_steps": [r.admit_step for r in reqs],
            "host_syncs": eng.host_syncs,
            "stats": {k: st[k] for k in ranks.COLD_ENGINE_KEYS},
            "calls": {k: v["calls"] for k, v in st["runtime"].items()},
            "tiered": st["tiered"]}


@pytest.fixture(scope="module")
def run():
    params = jax.jit(jbuild(jcfg()).init)(jax.random.key(29))
    tree = to_numpy_tree(params)
    rng = np.random.default_rng(5)
    vocab = jcfg().vocab_size
    prompts = [rng.integers(0, vocab, n, dtype=np.int32)
               for n in ranks.CACHE_PROMPTS]
    dec_toks = rng.integers(0, vocab, (ranks.DECODE_STEPS, 2),
                            dtype=np.int32)
    handles = {shape: launch(ranks.tiered_rank, shape, AXES,
                             (tree, prompts, dec_toks), timeout_s=300)
               for shape in ranks.EXECUTORS}
    try:
        ref = {"cache": {cold: ref_cache_run(cold, params, prompts, dec_toks)
                         for cold in COLDS},
               "engine": {name: ref_engine(name, params)
                          for name in ranks.TIERED_CASES}}
    finally:
        res = {shape: h.join() for shape, h in handles.items()}
    return ref, res


MESH_CASES = [(shape, ex) for shape, exs in ranks.EXECUTORS.items()
              for ex in exs]


def _ids(shape, ex):
    return f"{'x'.join(map(str, shape))}-{ex}"


# ---------------------------------------------------------------------------
# the cache functions on a rank's block (no processes)
# ---------------------------------------------------------------------------

def _filled(cold, B=2, n_kv=2, S=32, hd=8, seed=0):
    """A tiered cache with random stored bytes on both sides."""
    rng = np.random.default_rng(seed)
    jc = jcache.init_kv_cache(1, B, n_kv, S, hd, dtype=jnp.float32,
                              hot_window=ranks.HOT, cold_block=ranks.BLOCK,
                              cold_dtype=cold)
    bufs = {}
    for f in ("k", "v", "k_scale", "v_scale", "hot_k", "hot_v"):
        a = np.asarray(getattr(jc, f))
        if a.dtype == np.int8:
            bufs[f] = rng.integers(-100, 100, a.shape).astype(np.int8)
        else:
            bufs[f] = rng.uniform(0.01, 1.0, a.shape).astype(np.float32)
    return jc._replace(**{f: jnp.asarray(v) for f, v in bufs.items()}), bufs


def _block(bufs, lo, n, S):
    """The port's layer-0 slices of the block [lo, lo + S/n): cold buffers
    cut, the ring whole."""
    out = []
    for f in ("k", "v", "k_scale", "v_scale"):
        out.append(torch.from_numpy(bufs[f][0, :, :, lo:lo + S // n].copy()))
    return out + [torch.from_numpy(bufs[f][0].copy())
                  for f in ("hot_k", "hot_v")]


def _check_block(got, want, lo, n, S, what):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)[0]
        if i < 4:
            w = w[:, :, lo:lo + S // n]
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} {i}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("cold", COLDS)
def test_block_functions_equal_reference_parts(cold, n):
    """Each block of a sequence cut in ``n``: the decode append at ragged
    cursors (one row's cursor in each block in turn, one row inactive),
    the resolved read of the block's part of a bucket, the chunk write
    (a window across block edges, ``valid < C``, wrapping the ring) and
    the pre-write hot image equal the rank's part of the reference's
    whole-cache results, byte for byte."""
    S, hd = 32, 8
    jc, bufs = _filled(cold, S=S, hd=hd)
    rng = np.random.default_rng(1)
    k_new = rng.standard_normal((2, 2, hd)).astype(np.float32)
    v_new = rng.standard_normal((2, 2, hd)).astype(np.float32)
    geom = (ranks.HOT, ranks.BLOCK, cold)
    for cursor in (3, 9, 17, 30):
        pos = np.array([cursor, 5], np.int32)
        act = np.array([True, False])
        lay = jcache.layer_append_tiered(
            *(getattr(jc, f)[0] for f in ("k", "v", "k_scale", "v_scale",
                                          "hot_k", "hot_v")),
            jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos), cold,
            jnp.asarray(act))
        counts = jnp.asarray(pos + 1)
        want_read = jcache.layer_read_tiered(*lay, counts, 24, *geom,
                                             dtype=jnp.float32)
        for b in range(n):
            lo = b * S // n
            got = tcache.layer_append_tiered(
                *_block(bufs, lo, n, S), torch.from_numpy(k_new),
                torch.from_numpy(v_new), torch.from_numpy(pos), cold,
                torch.from_numpy(act), lo=lo)
            _check_block(got, [x[None] for x in lay], lo, n, S,
                         f"append cursor {cursor} block {b}")
            nb = max(0, min(S // n, 24 - lo))
            if nb:
                read = tcache.layer_read_tiered(
                    *got, torch.from_numpy(pos + 1), nb, *geom,
                    dtype=torch.float32, lo=lo)
                for r, w in zip(read, want_read):
                    np.testing.assert_array_equal(
                        r.numpy(), np.asarray(w)[:, :, lo:lo + nb])
    C = 6
    k_ch = rng.standard_normal((2, C, hd)).astype(np.float32)
    v_ch = rng.standard_normal((2, C, hd)).astype(np.float32)
    for start, valid in ((5, 6), (13, 4), (26, 6)):
        whole = [getattr(jc, f)[0] for f in ("k", "v", "k_scale", "v_scale",
                                             "hot_k", "hot_v")]
        want_img = jcache.chunk_hot_image(*whole[4:], jnp.asarray(k_ch),
                                          jnp.asarray(v_ch), 1, start, valid,
                                          S, dtype=jnp.float32)
        want = jcache.layer_write_chunk_tiered(
            *whole, jnp.asarray(k_ch), jnp.asarray(v_ch), 1, start, valid,
            cold)
        for b in range(n):
            lo = b * S // n
            blk = _block(bufs, lo, n, S)
            img = tcache.chunk_hot_image(
                *blk[4:], torch.from_numpy(k_ch), torch.from_numpy(v_ch), 1,
                start, valid, S // n, dtype=torch.float32, lo=lo)
            for g, w in zip(img, want_img):
                np.testing.assert_array_equal(
                    g.numpy(), np.asarray(w)[:, :, lo:lo + S // n])
            got = tcache.layer_write_chunk_tiered(
                *blk, torch.from_numpy(k_ch), torch.from_numpy(v_ch), 1,
                start, valid, cold, lo=lo)
            _check_block(got, [x[None] for x in want], lo, n, S,
                         f"chunk {start}+{valid} block {b}")


# ---------------------------------------------------------------------------
# the model on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cold", COLDS)
@pytest.mark.parametrize("shape, executor", MESH_CASES,
                         ids=[_ids(*c) for c in MESH_CASES])
def test_rank_parts_and_logits_equal_reference(run, shape, executor, cold):
    ref, res = run
    want_chunks, want_dec, jc = ref["cache"][cold]
    n_flips, n_vals = 0, 0
    for r in res[shape]:
        got = r["cache"][(executor, cold)]
        parts = cache_parts(jc, executor, shape, got["coords"])
        for f in ("hot_k", "hot_v"):
            w = parts[f]
            assert got["cache"][f].shape == w.shape, f
            err = np.abs(got["cache"][f] - w).max()
            assert err <= HOT_RTOL * np.abs(w).max(), (f, err)
        for f in ("k", "v"):
            assert got["cache"][f].shape == parts[f].shape, f
            n_flips += flips(got["cache"][f], parts[f], cold)
            n_vals += parts[f].size
        for f in ("k_scale", "v_scale"):
            np.testing.assert_allclose(got["cache"][f], parts[f],
                                       rtol=SCALE_RTOL, atol=0)
        if executor.endswith("+seqkv") and shape[1] > 1:
            assert got["seq_axes"] == ("model",)
            assert got["seq_lo"] == got["coords"]["model"] * \
                ranks.CACHE_S // shape[1]
    assert n_flips <= 1e-3 * n_vals, n_flips
    # once a stored step differs, the repo's rule for quantized caches
    rtol = LOGIT_RTOL if n_flips == 0 else FLIP_RTOL
    dec_rows = []
    for r in res[shape]:
        got = r["cache"][(executor, cold)]
        if got["coords"]["model"] == 0:
            dec_rows.append(got["dec_logits"])
        for key, lg in got["chunk_logits"].items():
            want = want_chunks[key]
            err = np.abs(lg - want).max()
            assert err <= rtol * np.abs(want).max(), (key, err)
        assert len(got["chunk_logits"]) == (3 + 2 if shape[0] == 1 else
                                            (3, 2)[got["coords"]["data"]])
    got_dec = np.concatenate(dec_rows, axis=1)            # (steps, 2, V)
    assert got_dec.shape == want_dec.shape
    err = np.abs(got_dec - want_dec).max()
    assert err <= rtol * np.abs(want_dec).max(), err
    top2 = np.sort(want_dec, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * rtol * np.abs(want_dec).max()
    np.testing.assert_array_equal(got_dec.argmax(-1)[clear],
                                  want_dec.argmax(-1)[clear])


# ---------------------------------------------------------------------------
# the engine on a mesh
# ---------------------------------------------------------------------------

ENGINE_CASES = [(shape, ex, name) for shape, ex in MESH_CASES
                for name in ranks.TIERED_CASES if ranks.runs_on(ex, name)]


@pytest.mark.parametrize(
    "shape, executor, name", ENGINE_CASES,
    ids=[f"{_ids(s, e)}-{n}" for s, e, n in ENGINE_CASES])
def test_engine_equals_reference_engine(run, shape, executor, name):
    ref, res = run
    want = ref["engine"][name]
    assert want["stats"]["completed"] == 3
    assert want["tiered"]["demotions"] > 0
    if "budget" in name:
        assert want["stats"]["preemptions"] >= 1
    for r in res[shape]:
        got = dict(r["engine"][(executor, name)])
        mesh = got.pop("mesh")
        assert got == want
        assert mesh["shape"] == dict(zip(AXES, shape))
