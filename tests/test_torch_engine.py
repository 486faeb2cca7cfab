"""Engine parity: the port's continuous-batching ServingEngine against the
JAX engine on the same f32 weights and the staggered request plans of
``test_macro_step.py`` / ``test_chunked_prefill.py``.

Per-request token streams must be identical for T=1 and T=8, monolithic
and chunked admission, with and without KV buckets, and the counted host
syncs must equal the reference's. The WA backend's knobs raise the
reference's validation errors where they do not combine (its parity with
the reference is ``test_torch_wa.py``'s); a tiered config serves (its
parity with the reference is ``test_torch_tiered.py``'s).
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs.registry import ASSIGNED                  # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.quant.int8 import QuantizedTensor as JaxQT        # noqa: E402
from repro.runtime.serving import Request as JaxRequest      # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.interop import params_from_numpy            # noqa: E402
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402

torch.set_num_threads(2)

PROMPT_LEN = 8
PLAN = [(9, 0), (13, 0), (5, 2), (9, 6)]
RAGGED = [(6, 0, 5), (6, 0, 8), (6, 2, 11), (6, 4, 3)]


def to_numpy_tree(tree):
    if isinstance(tree, JaxQT):
        return {"values": np.asarray(tree.values),
                "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    a = jnp.asarray(tree)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


@pytest.fixture(scope="module")
def models():
    jcfg = ASSIGNED["qwen2-0.5b"].reduced().replace(dtype="float32")
    tcfg = get_config("qwen2-0.5b").reduced().replace(dtype="float32")
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(to_numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, japi, jparams, tapi, tparams


def _requests(cls, cfg, plan, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, entry in enumerate(plan):
        new, arr, plen = entry if len(entry) == 3 else entry + (PROMPT_LEN,)
        out.append(cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, plen,
                                                   dtype=np.int32),
                       max_new_tokens=new, arrival_step=arr))
    return out


CASES = {
    # name: (plan, block_size, kv_bucket_chunk, prefill_chunk)
    "t1_mono": (PLAN, 1, 0, 0),
    "t8_mono_buckets": (PLAN, 8, 16, 0),
    "t8_chunk3_buckets": (PLAN, 8, 16, 3),
    "t1_chunk4_ragged": (RAGGED, 1, 0, 4),
    "t8_chunk4_ragged_buckets": (RAGGED, 8, 16, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_token_streams_and_host_syncs_match_reference(models, case):
    cfg, japi, jparams, tapi, tparams = models
    plan, T, bucket, chunk = CASES[case]
    kw = dict(block_size=T, kv_bucket_chunk=bucket, prefill_chunk=chunk,
              max_new_cap=32)
    jreqs = _requests(JaxRequest, cfg, plan)
    jeng = JaxEngine(japi, NULL_CTX, 2, PROMPT_LEN, mode="continuous", **kw)
    jstats = jeng.run(jparams, jreqs, max_steps=400)
    treqs = _requests(Request, cfg, plan)
    teng = ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", **kw)
    tstats = teng.run(tparams, treqs, max_steps=400)
    assert tstats["completed"] == jstats["completed"] == len(plan)
    for a, b in zip(jreqs, treqs):
        assert b.generated == a.generated, (case, a.rid)
        assert b.admit_step == a.admit_step, (case, a.rid)
    assert teng.host_syncs == jeng.host_syncs
    for key in ("decode_steps", "macro_steps", "decode_tokens",
                "prefill_chunks", "admissions", "overlapped_admissions"):
        assert tstats[key] == jstats[key], key
    # the same program set, each registered once, called as often
    jrt, trt = jstats["runtime"], tstats["runtime"]
    assert set(trt) == set(jrt)
    for name in trt:
        assert trt[name]["compiles"] == 1
        assert trt[name]["calls"] == jrt[name]["calls"], name


def test_debug_reset_slots_zeroes_retired(models):
    cfg, _, _, tapi, tparams = models
    plan = PLAN + [(1, 4)]
    eng = ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", max_new_cap=32,
                        block_size=4, debug_reset_slots=True)
    stats = eng.run(tparams, _requests(Request, cfg, plan), max_steps=400)
    assert stats["completed"] == len(plan)
    assert stats["runtime"]["serve_reset"]["calls"] == len(plan)
    assert not eng._caches.k.any() and not eng._caches.v.any()


def test_engine_reuse_and_submit(models):
    """A second run starts from fresh caches and accumulators; requests
    submitted before run() are served."""
    cfg, _, _, tapi, tparams = models
    eng = ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", max_new_cap=32,
                        block_size=4)
    ra = _requests(Request, cfg, PLAN)
    sa = eng.run(tparams, ra, max_steps=400)
    rb = _requests(Request, cfg, PLAN)
    eng.submit(rb[0])
    sb = eng.run(tparams, rb[1:], max_steps=400)
    assert sb["completed"] == sa["completed"] == len(PLAN)
    assert sb["host_syncs"] == sa["host_syncs"]
    for a, b in zip(ra, rb):
        assert a.generated == b.generated


def test_length_contract_rejects_not_truncates(models):
    cfg, _, _, tapi, _ = models
    mono = ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", max_new_cap=32)
    long = Request(rid=7, prompt=np.ones(PROMPT_LEN + 1, np.int32),
                   max_new_tokens=4)
    with pytest.raises(ValueError, match="prompt length"):
        mono.submit(long)
    chunked = ServingEngine(tapi, 2, PROMPT_LEN, device="cpu",
                            max_new_cap=32, prefill_chunk=4)
    chunked.submit(long)                 # fits the KV extent: admitted
    with pytest.raises(ValueError, match="KV extent"):
        chunked.submit(Request(rid=8, prompt=np.ones(39, np.int32),
                               max_new_tokens=4))
    with pytest.raises(ValueError, match="max_new_tokens"):
        mono.submit(Request(rid=9, prompt=np.ones(4, np.int32),
                            max_new_tokens=0))


UNPORTED = {
    # knob: (engine kwargs, the error's words)
    # ported with the tiered cache: on a flat cache it raises as the
    # reference does (tests/test_torch_tiered.py holds the tiered case)
    "kv_budget_bytes": (dict(kv_budget_bytes=1 << 20),
                        "flat caches have no arbiter"),
}


@pytest.mark.parametrize("knob", sorted(UNPORTED))
def test_unported_knob_raises(models, knob):
    _, _, _, tapi, _ = models
    kw, words = UNPORTED[knob]
    with pytest.raises(ValueError, match=words):
        ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", **kw)


WA_ERRORS = {
    # case: (slots, engine kwargs, the reference's words)
    "overlap_without_wa": (2, dict(overlap=2), "no W↔A hops to overlap"),
    "slots_not_divisible_by_overlap": (
        3, dict(backend="wa", overlap=2),
        "does not divide into overlap=2 equal micro-batches"),
    "wa_with_drain": (2, dict(backend="wa", mode="drain"),
                      "drain mode is colocated-only"),
}


@pytest.mark.parametrize("case", sorted(WA_ERRORS))
def test_wa_validation_raises(models, case):
    """The WA backend and its overlap serve (``test_torch_wa.py``); the
    combinations the reference refuses raise its errors."""
    _, japi, _, tapi, _ = models
    slots, kw, words = WA_ERRORS[case]
    with pytest.raises(ValueError, match=words):
        JaxEngine(japi, NULL_CTX, slots, PROMPT_LEN, **kw)
    with pytest.raises(ValueError, match=words):
        ServingEngine(tapi, slots, PROMPT_LEN, device="cpu", **kw)


def test_failure_model_request_fields_accepted(models):
    """The failure-model request fields are ported: ``submit`` queues a
    request that carries them (``tests/test_torch_failure.py`` and
    ``tests/test_torch_chaos.py`` hold their behaviour)."""
    _, _, _, tapi, _ = models
    eng = ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", max_new_cap=32)
    for field in ("priority", "ttft_deadline_ms", "tpot_deadline_ms"):
        r = Request(rid=0, prompt=np.ones(4, np.int32), max_new_tokens=2)
        setattr(r, field, 1)
        eng.submit(r)
        assert eng.queue[-1] is r and r.status == "queued"


def test_unported_configs_raise():
    """A tiered config (the default int8 cold tier, blocks of 16) builds
    and serves, demoting on the way; the VLM builds and its engine
    resolves to continuous; the enc-dec family builds and the engine
    refuses it (its prefill has no frames input)."""
    tcfg = get_config("qwen2-0.5b").reduced().replace(hot_window=16)
    api = build_model(tcfg, device="cpu")
    eng = ServingEngine(api, 2, PROMPT_LEN, device="cpu", max_new_cap=32,
                        block_size=4, kv_bucket_chunk=16, prefill_chunk=4)
    reqs = _requests(Request, tcfg, [(28, 0), (9, 2)])
    stats = eng.run(api.init(0), reqs, max_steps=400)
    assert stats["completed"] == 2
    assert [len(r.generated) for r in reqs] == [28, 9]
    assert stats["tiered"]["cold_dtype"] == "int8"
    assert stats["tiered"]["demotions"] > 0
    vlm = build_model(get_config("internvl2-76b").reduced(), device="cpu")
    assert ServingEngine(vlm, 2, PROMPT_LEN, device="cpu").mode == \
        "continuous"
    audio = build_model(get_config("whisper-medium").reduced(),
                        device="cpu")
    with pytest.raises(ValueError, match="has no frames input"):
        ServingEngine(audio, 2, PROMPT_LEN, device="cpu")
