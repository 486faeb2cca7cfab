"""The hybrid family (RecurrentGemma: RG-LRU and local attention over a
ring KV cache) of the port against the JAX reference.

Reduced recurrentgemma-9b (3 layers: one (R, R, A) superblock, d_model
128, 4 query heads on 1 KV head of 32, window 32), float32 weights made by
the reference and moved with ``interop``; numpy seeds make the inputs.

- the ring functions (the shared-cursor append across the wrap, float and
  int8; ``slot_valid_mask`` with a window; ``write_prefill`` with S longer
  than the ring) give the reference's arrays exactly; banded
  ``flash_attention`` holds to 1e-5;
- the RG-LRU functions (the log-depth ``linear_scan`` against
  ``associative_scan``, ``rglru_full_seq`` over a length no power of two,
  ``rglru_final_state``, ``rglru_decode``) hold to 1e-4 of the
  reference's largest magnitude;
- the model: prefill of a prompt longer than the window, then decode
  steps that wrap the ring, with the logits compared at every step (the
  reduced model's streams repeat one token, so tokens alone would prove
  little): within 1e-4 of max|logit|, tokens exact; in bfloat16 within
  2e-2;
- the engine: ``mode="auto"`` resolves to drain, as in the reference,
  and gives the JAX engine's streams, host syncs and per-program calls;
- the refusals and the ``prefill_chunk`` warning carry the reference's
  messages.
"""
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs.registry import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.kv import cache as jcache                         # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.models import attention as jattn                  # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.models import rglru as jrg                        # noqa: E402
from repro.models import transformer as jtr                  # noqa: E402
from repro.runtime.serving import Request as JaxRequest      # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.interop import kv_cache_from_numpy, params_from_numpy  # noqa
from repro_torch.kv import cache as tcache                   # noqa: E402
from repro_torch.models import attention as tattn            # noqa: E402
from repro_torch.models import rglru as trg                  # noqa: E402
from repro_torch.models import transformer as ttr            # noqa: E402
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402
from test_torch_engine import to_numpy_tree                  # noqa: E402

torch.set_num_threads(2)

ARCH = "recurrentgemma-9b"
RTOL = 1e-4
BF16_RTOL = 2e-2


def _pair(dtype="float32", **over):
    jcfg = JAX_REGISTRY[ARCH].reduced().replace(dtype=dtype, **over)
    tcfg = get_config(ARCH).reduced().replace(dtype=dtype, **over)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(to_numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, tcfg, japi, jparams, tapi, tparams


@pytest.fixture(scope="module")
def models():
    return _pair()


def close(got, want, rtol=RTOL, tokens=True):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())
    if tokens:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# ring functions: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_ring_append_across_the_wrap_equals_reference(quantized):
    """12 shared-cursor appends into a ring of 5 slots (the cursor wraps
    twice), float32 or int8 with scales: every byte equals the
    reference's."""
    rng = np.random.default_rng(0)
    B, n_kv, size, hd = 2, 1, 5, 8
    jc = jcache.init_kv_cache(1, B, n_kv, 40, hd, dtype=jnp.float32,
                              quantized=quantized, window=size)
    tc = tcache.init_kv_cache(1, B, n_kv, 40, hd, dtype=torch.float32,
                              quantized=quantized, window=size)
    assert tc.k.shape == jc.k.shape and tc.window == jc.window == size
    jl = (jc.k[0], jc.v[0], None if jc.k_scale is None else jc.k_scale[0],
          None if jc.v_scale is None else jc.v_scale[0])
    tl = tc.layer(0)
    for pos in range(12):
        kn = rng.standard_normal((B, n_kv, hd)).astype(np.float32)
        vn = rng.standard_normal((B, n_kv, hd)).astype(np.float32)
        jl = jcache.layer_append(*jl, jnp.asarray(kn), jnp.asarray(vn),
                                 jnp.asarray(pos), size)
        tl = tcache.layer_append_ring(*tl, _t(kn), _t(vn),
                                      torch.tensor(pos, dtype=torch.int32))
        for a, b in zip(tl, jl):
            if b is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_slot_valid_mask_with_a_window_equals_reference():
    for size, window in ((5, 5), (8, 5), (32, 32), (7, 0)):
        for q in range(0, 3 * size):
            np.testing.assert_array_equal(
                tcache.slot_valid_mask(size, torch.tensor(q), window).numpy(),
                np.asarray(jcache.slot_valid_mask(size, window,
                                                  jnp.asarray(q))))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("S", [3, 5, 13, 32])
def test_write_prefill_rolls_a_long_prompt_into_the_ring(S, quantized):
    """A prompt of S positions into a ring of 5: the last 5 positions in
    slot p % 5, the length S."""
    rng = np.random.default_rng(S)
    k = rng.standard_normal((2, 2, 1, S, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 1, S, 8)).astype(np.float32)
    jc = jcache.init_kv_cache(2, 2, 1, S + 4, 8, dtype=jnp.float32,
                              quantized=quantized, window=5)
    tc = tcache.init_kv_cache(2, 2, 1, S + 4, 8, dtype=torch.float32,
                              quantized=quantized, window=5)
    jc = jtr.write_prefill(jc, jnp.asarray(k), jnp.asarray(v), S)
    tc = ttr.write_prefill(tc, _t(k), _t(v), S)
    for f in ("k", "v", "k_scale", "v_scale", "length"):
        a, b = getattr(tc, f), getattr(jc, f)
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_banded_flash_attention_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 45, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 45, 1, 32)).astype(np.float32)
    v = rng.standard_normal((2, 45, 1, 32)).astype(np.float32)
    for window in (0, 7, 32):
        want = jattn.flash_attention_padded(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, window,
            16, 16)
        got = tattn.flash_attention(_t(q), _t(k), _t(v), window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# RG-LRU functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 7, 45, 64])
def test_linear_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 16)).astype(np.float32)
    b = rng.standard_normal((2, S, 16)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e1[1] * e2[0] + e2[1]

    _, want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(b))
    got = trg.linear_scan(_t(a), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_rglru_functions_match_reference(models):
    jcfg, tcfg, _, jparams, _, tparams = models
    jp = jax.tree.map(lambda a: a[0], jparams["super"]["r2"]["mix"])
    tp = tparams["super"][0]["r2"]["mix"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 45, jcfg.d_model)).astype(np.float32)
    close(trg.rglru_full_seq(tp, _t(x), tcfg).numpy(),
          jax.jit(lambda x: jrg.rglru_full_seq(jp, x, jcfg, NULL_CTX))(
              jnp.asarray(x)), tokens=False)
    jh, jc = jax.jit(lambda x: jrg.rglru_final_state(jp, x, jcfg, NULL_CTX)
                     )(jnp.asarray(x))
    th, tc = trg.rglru_final_state(tp, _t(x), tcfg)
    close(th.numpy(), jh, tokens=False)
    close(tc.numpy(), jc, tokens=False)
    jdec = jax.jit(lambda x, h, c: jrg.rglru_decode(jp, x, jcfg, NULL_CTX,
                                                    h, c))
    for step in range(3):
        x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jo, jh, jc = jdec(jnp.asarray(x1), jh, jc)
        to, th, tc = trg.rglru_decode(tp, _t(x1), tcfg, th, tc)
        close(to.numpy(), jo, tokens=False)
        close(th.numpy(), jh, tokens=False)
        close(tc.numpy(), jc, tokens=False)


# ---------------------------------------------------------------------------
# model programs
# ---------------------------------------------------------------------------

def _run_model(cfgs, rtol, S=45, steps=40):
    """Prefill of two rows of S (> window 32: the ring rolls), then
    ``steps`` shared-cursor decode steps that wrap the ring; both sides
    take the reference's tokens and the logits are compared at every
    step. Tokens too in f32 (a bf16 near-tie may pick another argmax)."""
    jcfg, tcfg, japi, jparams, tapi, tparams = cfgs
    exact = rtol == RTOL
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, S), dtype=np.int32)
    jc, jl = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, NULL_CTX)
    tc, tl = tapi.prefill(tparams, _t(toks).long())
    assert tc["kv"].k.shape == jc["kv"].k.shape
    assert tc["kv"].window == jc["kv"].window == jcfg.rglru.window
    close(tl.float().numpy(), jl, rtol, exact)
    tok = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)
    jdec = jax.jit(lambda p, c, t: japi.decode(p, c, t, NULL_CTX))
    for _ in range(steps):
        jc, jl = jdec(jparams, jc, jnp.asarray(tok))
        tc, tl = tapi.decode(tparams, tc, _t(tok).long())
        close(tl.float().numpy(), jl, rtol, exact)
        tok = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(tc["kv"].length.numpy(),
                                  np.asarray(jc["kv"].length))
    assert int(tc["kv"].length) > tc["kv"].k.shape[3] + steps // 2  # wraps
    return jc, tc


def test_model_programs_match_reference(models):
    jc, tc = _run_model(models, RTOL)
    close(tc["state"].h.numpy(), jc["state"].h, tokens=False)
    close(tc["kv"].k.numpy(), jc["kv"].k, tokens=False)


def test_model_programs_match_reference_int8_kv():
    """int8 ring KV: the stored bytes may differ by a rounding step where
    the two sides' K differ in the last bit, so the logits hold to
    2e-2."""
    _run_model(_pair(kv_dtype="int8"), BF16_RTOL, S=37, steps=12)


def test_model_programs_match_reference_in_bfloat16():
    """bf16 weights and activations (the RG-LRU state and lam stay f32):
    logits within 2e-2 of max|logit| at every step (bf16 keeps 8 bits;
    the two sides sum in different orders, so a near-tie can pick another
    argmax: tokens are not compared)."""
    cfgs = _pair("bfloat16")
    mix = cfgs[5]["super"][0]["r1"]["mix"]
    assert mix["lam"].dtype == torch.float32
    assert mix["in_a"]["w"].dtype == torch.bfloat16
    _run_model(cfgs, BF16_RTOL, steps=12)


def test_interop_loads_a_reference_ring_cache(models):
    jcfg, tcfg, japi, jparams, tapi, tparams = models
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 40),
                                             dtype=np.int32)
    jc, _ = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, NULL_CTX)
    kv = kv_cache_from_numpy({f: None if getattr(jc["kv"], f) is None
                              else np.asarray(getattr(jc["kv"], f))
                              for f in ("k", "v", "k_scale", "v_scale",
                                        "length")}, tcfg, device="cpu",
                             window=tcfg.rglru.window)
    assert kv.window == 32 and kv.k.shape == jc["kv"].k.shape
    np.testing.assert_array_equal(kv.k.numpy(), np.asarray(jc["kv"].k))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

PLAN = [(9, 0), (13, 0), (5, 2), (30, 6)]
PROMPT = 40                       # longer than the window of 32


def _requests(cls, vocab, plan, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, PROMPT,
                                           dtype=np.int32),
                max_new_tokens=new, arrival_step=arr)
            for i, (new, arr) in enumerate(plan)]


def test_engine_auto_resolves_to_drain_and_matches_reference(models):
    jcfg, tcfg, japi, jparams, tapi, tparams = models
    jreqs = _requests(JaxRequest, jcfg.vocab_size, PLAN)
    jeng = JaxEngine(japi, NULL_CTX, 2, PROMPT, mode="auto", max_new_cap=32)
    jstats = jeng.run(jparams, jreqs, max_steps=400)
    treqs = _requests(Request, jcfg.vocab_size, PLAN)
    teng = ServingEngine(tapi, 2, PROMPT, device="cpu", mode="auto",
                         max_new_cap=32)
    assert ServingEngine(tapi, 2, PROMPT, device="cpu").mode == "drain"
    tstats = teng.run(tparams, treqs, max_steps=400)
    assert tstats["mode"] == jstats["mode"] == "drain"
    assert tstats["completed"] == jstats["completed"] == len(PLAN)
    for a, b in zip(jreqs, treqs):
        assert b.generated == a.generated, a.rid
        assert b.admit_step == a.admit_step, a.rid
    assert teng.host_syncs == jeng.host_syncs
    for key in ("decode_steps", "macro_steps", "decode_tokens",
                "admissions"):
        assert tstats[key] == jstats[key], key
    jrt = {k: v["calls"] for k, v in jstats["runtime"].items()}
    trt = {k: v["calls"] for k, v in tstats["runtime"].items()}
    assert trt == jrt == {"serve_prefill_batch": 2,
                          "serve_decode_drain": jrt["serve_decode_drain"]}


REFUSALS = [
    (dict(mode="continuous"), "hybrid family has no slotted serving"),
    (dict(mode="continuous", prefill_chunk=4),
     "hybrid family has no chunked-prefill serving"),
    (dict(backend="wa"), "hybrid family has no WA-disaggregated"),
    (dict(a_shards=2), "split-KV decode .a_shards > 1. runs through"),
    (dict(preemptible=True), "preemptible serving requires the continuous"),
    (dict(kv_budget_bytes=10), "tiered-KV arbiter's pressure knob"),
    (dict(mode="drain", prefill_chunk=4), "chunked prefill requires the "
     "continuous"),
]


@pytest.mark.parametrize("kw,match", REFUSALS)
def test_refusals_match_reference(models, kw, match):
    jcfg, tcfg, japi, _, tapi, _ = models
    with pytest.raises(ValueError, match=match):
        JaxEngine(japi, NULL_CTX, 2, 8, **kw)
    with pytest.raises(ValueError, match=match):
        ServingEngine(tapi, 2, 8, device="cpu", **kw)


def test_prefill_chunk_under_auto_warns_and_serves_drain(models):
    jcfg, tcfg, japi, _, tapi, _ = models
    msg = "hybrid family has no prefill_chunk support; falling back"
    with pytest.warns(UserWarning, match=msg):
        jeng = JaxEngine(japi, NULL_CTX, 2, 8, prefill_chunk=4)
    with pytest.warns(UserWarning, match=msg):
        teng = ServingEngine(tapi, 2, 8, device="cpu", prefill_chunk=4)
    assert teng.mode == jeng.mode == "drain"
    assert teng.prefill_chunk == jeng.prefill_chunk == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ServingEngine(tapi, 2, 8, device="cpu")       # no lane asked: silent


def test_chunked_prefill_over_a_ring_raises():
    """The transformer chunk program refuses a ring cache, with the
    reference's message."""
    cfg = get_config(ARCH).reduced()
    ring = tcache.init_kv_cache(1, 1, 1, 16, 32, window=8)
    with pytest.raises(ValueError, match="non-windowed cache"):
        ttr.prefill_chunk({}, ring, torch.zeros(1, 4, dtype=torch.long), 0,
                          0, 4, cfg)
