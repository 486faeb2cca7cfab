"""The VLM family (internvl2 backbone) and learned positions of the port
against the JAX reference.

Reduced internvl2-76b (3 layers, d_model 128, 4 query heads on 2 KV heads
of 32, 4 vision tokens), weights made by the reference and moved with
``interop``; numpy seeds make the tokens and the vision embeddings.

- prefill with the vision embeddings before the text (RoPE positions over
  the whole sequence, the cache sized for text + vision + 128), then
  shared-cursor decode and slotted decode: logits at every step within
  1e-4 of max|logit| in float32 (tokens exact), 3e-2 in bfloat16;
- the serving engine serves the family text-only, as the reference
  engine does: ``auto`` resolves to continuous with monolithic admission,
  and the token streams, host syncs and per-program calls equal the JAX
  engine's; the chunk lane and the WA backend are refused (or, for the
  chunk lane under ``auto``, warned about) with the reference's messages;
- learned positions (``qwen2-0.5b`` reduced with ``pos="learned"``)
  through prefill, shared-cursor and slotted decode and the chunk lane,
  and the decoder-only sinusoidal positions refused.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs.registry import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.runtime.serving import Request as JaxRequest      # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.interop import params_from_numpy            # noqa: E402
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402
from test_torch_model import BF16_RTOL, LOGIT_RTOL, to_numpy_tree  # noqa

torch.set_num_threads(2)

ARCH = "internvl2-76b"
P = 8            # text tokens of a prompt


def _pair(arch=ARCH, **over):
    jcfg = JAX_REGISTRY[arch].reduced().replace(**over)
    tcfg = get_config(arch).reduced().replace(**over)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(to_numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, tcfg, japi, jparams, tapi, tparams


@pytest.fixture(scope="module")
def models():
    return _pair(dtype="float32")


def close(got, want, rtol=LOGIT_RTOL, tokens=True):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())
    if tokens:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, P), dtype=np.int32)
    vis = rng.standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return toks, vis


def _prefill(cfgs, toks, vis):
    jcfg, tcfg, japi, jparams, tapi, tparams = cfgs
    jc, jl = japi.prefill(jparams, {"tokens": jnp.asarray(toks),
                                    "vision_embeds": jnp.asarray(vis)},
                          NULL_CTX)
    tc, tl = tapi.prefill(tparams, _t(toks).long(), vision_embeds=_t(vis))
    return jc, jl, tc, tl


# ---------------------------------------------------------------------------
# model programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_vision_then_decode_matches_reference(models, dtype):
    """Vision embeddings before the text: the cache holds text + vision
    positions (+128), the logits match at the prefill and at 6
    shared-cursor decode steps, and the stored K/V at the end."""
    cfgs = models if dtype == "float32" else _pair(dtype=dtype)
    jcfg, tcfg, japi, jparams, tapi, tparams = cfgs
    rtol, exact = (LOGIT_RTOL, True) if dtype == "float32" \
        else (BF16_RTOL, False)
    toks, vis = _inputs(jcfg)
    jc, jl, tc, tl = _prefill(cfgs, toks, vis)
    n = P + jcfg.n_vision_tokens
    assert tc.k.shape == jc.k.shape == (jcfg.n_layers, 2, jcfg.n_kv_heads,
                                        n + 128, jcfg.head_dim)
    assert int(tc.length) == int(jc.length) == n
    close(tl.float().numpy(), jl, rtol, exact)
    tok = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)
    jdec = jax.jit(lambda p, c, t: japi.decode(p, c, t, NULL_CTX))
    for _ in range(6):
        jc, jl = jdec(jparams, jc, jnp.asarray(tok))
        tc, tl = tapi.decode(tparams, tc, _t(tok).long())
        close(tl.float().numpy(), jl, rtol, exact)
        tok = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)
    assert int(tc.length) == int(jc.length) == n + 6
    close(tc.k.float().numpy(), np.asarray(jc.k, np.float32), rtol,
          tokens=False)


def test_vision_embeds_reach_the_logits(models):
    """The same text with and without vision embeddings gives other
    logits, each equal to the reference's."""
    jcfg, tcfg, japi, jparams, tapi, tparams = models
    toks, vis = _inputs(jcfg, seed=3)
    _, jl, _, tl = _prefill(models, toks, vis)
    jc0, jl0 = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, NULL_CTX)
    tc0, tl0 = tapi.prefill(tparams, _t(toks).long())
    close(tl0.numpy(), jl0)
    assert tc0.k.shape[3] == jc0.k.shape[3]
    assert np.abs(tl.numpy() - tl0.numpy()).max() > 1e-3


def test_slotted_decode_after_vision_prefill_matches_reference(models):
    """Two batch-1 prefills with vision written into slots of a serving
    cache, then 5 slotted steps from their own cursors (row 1 idles for
    the last two): logits of the live rows at every step."""
    jcfg, tcfg, japi, jparams, tapi, tparams = models
    S = P + jcfg.n_vision_tokens + 16
    jc, tc = japi.init_caches(2, S), tapi.init_caches(2, S)
    first = []
    for slot in range(2):
        toks, vis = _inputs(jcfg, B=1, seed=10 + slot)
        js, jl, ts, tl = _prefill(models, toks, vis)
        jc = japi.write_slot(jc, js, slot)
        tc = tapi.write_slot(tc, ts, slot)
        close(tl.numpy(), jl)
        first.append(int(np.asarray(jl[0, -1]).argmax()))
    tok = np.array(first, np.int32)
    pos = np.full((2,), P + jcfg.n_vision_tokens, np.int32)
    jstep = jax.jit(lambda *xs: japi.decode_slotted(*xs, NULL_CTX))
    for step in range(5):
        act = np.array([True, step < 3])
        jc, jl = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(pos),
                       jnp.asarray(act))
        tc, tl = tapi.decode_slotted(tparams, tc, _t(tok), _t(pos), _t(act))
        close(tl[act, 0].numpy(), np.asarray(jl)[act, 0])
        tok = np.where(act, np.asarray(jl[:, 0]).argmax(-1), 0) \
            .astype(np.int32)
        pos = pos + act
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jc.k)).max())


def test_model_api_fields_follow_the_reference(models):
    """Slotted decode and monolithic admission; no chunk lane, no WA."""
    japi, tapi = models[2], models[4]
    assert japi.prefill_chunk is None and tapi.prefill_chunk is None
    assert not japi.wa_servable and not tapi.wa_servable
    assert tapi.decode_slotted is not None and tapi.write_slot is not None


# ---------------------------------------------------------------------------
# engine: text-only, as the reference engine serves the family
# ---------------------------------------------------------------------------

PLAN = [(9, 0), (13, 0), (5, 2), (17, 6), (4, 7)]
PROMPT = 8
ENGINE_KW = {"per-token": {},
             "block": dict(block_size=4, kv_bucket_chunk=16)}


def _requests(cls, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, PROMPT,
                                           dtype=np.int32),
                max_new_tokens=new, arrival_step=arr)
            for i, (new, arr) in enumerate(PLAN)]


@pytest.mark.parametrize("case", sorted(ENGINE_KW))
def test_engine_serves_text_only_like_reference(models, case):
    jcfg, tcfg, japi, jparams, tapi, tparams = models
    kw = dict(ENGINE_KW[case], max_new_cap=32)
    jreqs = _requests(JaxRequest, jcfg.vocab_size)
    jeng = JaxEngine(japi, NULL_CTX, 2, PROMPT, **kw)
    jstats = jeng.run(jparams, jreqs, max_steps=400)
    treqs = _requests(Request, jcfg.vocab_size)
    teng = ServingEngine(tapi, 2, PROMPT, device="cpu", **kw)
    tstats = teng.run(tparams, treqs, max_steps=400)
    assert tstats["mode"] == jstats["mode"] == "continuous"
    assert tstats["prefill_mode"] == jstats["prefill_mode"] == "monolithic"
    assert tstats["completed"] == jstats["completed"] == len(PLAN)
    for a, b in zip(jreqs, treqs):
        assert b.generated == a.generated, a.rid
        assert b.admit_step == a.admit_step, a.rid
    assert teng.host_syncs == jeng.host_syncs
    jrt = {k: v["calls"] for k, v in jstats["runtime"].items()}
    trt = {k: v["calls"] for k, v in tstats["runtime"].items()}
    assert trt == jrt
    assert trt["serve_prefill1"] == trt["serve_admit"] == len(PLAN)


REFUSALS = [
    (dict(backend="wa"), "vlm family has no WA-disaggregated"),
    (dict(mode="continuous", prefill_chunk=4),
     "vlm family has no chunked-prefill serving"),
]


@pytest.mark.parametrize("kw,match", REFUSALS)
def test_refusals_match_reference(models, kw, match):
    japi, tapi = models[2], models[4]
    with pytest.raises(ValueError, match=match):
        JaxEngine(japi, NULL_CTX, 2, 8, **kw)
    with pytest.raises(ValueError, match=match):
        ServingEngine(tapi, 2, 8, device="cpu", **kw)


def test_prefill_chunk_under_auto_warns_and_admits_monolithically(models):
    japi, tapi = models[2], models[4]
    msg = "vlm family has no prefill_chunk support; falling back"
    with pytest.warns(UserWarning, match=msg):
        jeng = JaxEngine(japi, NULL_CTX, 2, 8, prefill_chunk=4)
    with pytest.warns(UserWarning, match=msg):
        teng = ServingEngine(tapi, 2, 8, device="cpu", prefill_chunk=4)
    assert teng.mode == jeng.mode == "continuous"
    assert teng.prefill_chunk == jeng.prefill_chunk == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ServingEngine(tapi, 2, 8, device="cpu")       # no lane asked: silent


# ---------------------------------------------------------------------------
# learned positions in a decoder-only model
# ---------------------------------------------------------------------------

def test_learned_positions_match_reference():
    """qwen2-0.5b reduced with ``pos="learned"`` (f32; no RoPE, the table
    of 33,024 rows added to the embeddings): batch prefill + 4
    shared-cursor steps; two batch-1 prefills in slots + 4 slotted steps;
    an 11-token prompt in chunks of 4 into slot 1 (the chunk lane): logits
    within 1e-4 of max|logit| everywhere, tokens exact."""
    cfgs = _pair("qwen2-0.5b", dtype="float32", pos="learned")
    jcfg, tcfg, japi, jparams, tapi, tparams = cfgs
    assert tparams["pos_embed"].shape == (32768 + 256, jcfg.d_model)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (2, P), dtype=np.int32)
    jc, jl = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, NULL_CTX)
    tc, tl = tapi.prefill(tparams, _t(toks).long())
    close(tl.numpy(), jl)
    tok = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)
    jdec = jax.jit(lambda p, c, t: japi.decode(p, c, t, NULL_CTX))
    for _ in range(4):
        jc, jl = jdec(jparams, jc, jnp.asarray(tok))
        tc, tl = tapi.decode(tparams, tc, _t(tok).long())
        close(tl.numpy(), jl)
        tok = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)
    S = 40
    jc, tc = japi.init_caches(2, S), tapi.init_caches(2, S)
    first = []
    for slot in range(2):
        row = toks[slot:slot + 1]
        js, jl = japi.prefill(jparams, {"tokens": jnp.asarray(row)},
                              NULL_CTX)
        ts, tl = tapi.prefill(tparams, _t(row).long())
        jc, tc = japi.write_slot(jc, js, slot), tapi.write_slot(tc, ts, slot)
        first.append(int(np.asarray(jl[0, -1]).argmax()))
    tok, pos = np.array(first, np.int32), np.array([P, P], np.int32)
    act = np.ones(2, bool)
    jstep = jax.jit(lambda *xs: japi.decode_slotted(*xs, NULL_CTX))
    for _ in range(4):
        jc, jl = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(pos),
                       jnp.asarray(act))
        tc, tl = tapi.decode_slotted(tparams, tc, _t(tok), _t(pos), _t(act))
        close(tl[:, 0].numpy(), jl[:, 0])
        tok = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)
        pos = pos + 1
    prompt = rng.integers(0, jcfg.vocab_size, 11, dtype=np.int32)
    jfn = jax.jit(lambda *xs: japi.prefill_chunk(*xs, NULL_CTX))
    for start in range(0, 11, 4):
        n = min(4, 11 - start)
        row = np.zeros((1, 4), np.int32)
        row[0, :n] = prompt[start:start + n]
        jc, jl = jfn(jparams, jc, jnp.asarray(row), jnp.asarray(1),
                     jnp.asarray(start), jnp.asarray(n))
        tc, tl = tapi.prefill_chunk(tparams, tc, _t(row).long(), 1, start, n)
        close(tl[:, -1].numpy(), jl[:, -1])


def test_decoder_only_sinusoidal_positions_are_refused():
    """The reference adds sinusoidal positions at prefill but not at
    decode; the port refuses the combination rather than copy the gap."""
    cfg = get_config("qwen2-0.5b").reduced().replace(pos="sinusoidal")
    with pytest.raises(ValueError, match="sinusoidal.*not ported"):
        build_model(cfg, device="cpu")
