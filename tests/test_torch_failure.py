"""The failure model of the port against the JAX engine, on one fake clock.

- the swap pair (``export_slot_kv`` / ``import_slot_kv``) gives the
  reference's bytes exactly, for dense and int8 KV (values and scales);
- a preempt-then-restore serve is token-identical to an uninterrupted one
  at T in {1, 8} and a_shards in {1, 2}, and equal to the JAX engine's
  serve of the same plan (streams, statuses, counters, per-program calls);
  the swap pair is registered once; with int8 KV (the port alone) it is
  token-identical too;
- the reference's policy cases (TTFT shedding, the bounded queue, a
  transient and a persistent dispatch fault, a failed swap-out, the
  mid-block EOS / restore race) and every other demotion path (a failed
  chunk or monolithic admission, a failed restore, a failed debug reset,
  all slots quarantined) give the reference's statuses, reasons, streams
  and counters;
- an exception other than ``DispatchError`` propagates out of ``run()``
  untouched: it is never retried, demoted or quarantined.

Deadlines, the watchdog and the retry backoff read the clock, so every
comparison runs both engines on one ``FakeClock``: its time moves only by a
fixed step per program dispatch and by ``sleep``, so both engines,
dispatching in the same order, see the same timeline.
"""
import pytest

torch = pytest.importorskip("torch")

import types                                                 # noqa: E402

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import repro.kv.cache as jcache                              # noqa: E402
import repro.runtime.faults as jfaults                       # noqa: E402
import repro.runtime.serving as jserving                     # noqa: E402
import repro_torch.launch.serve as serve_cli                 # noqa: E402
import repro_torch.runtime.faults as tfaults                 # noqa: E402
import repro_torch.runtime.serving as tserving               # noqa: E402
from repro.configs.registry import ASSIGNED                  # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.quant.int8 import QuantizedTensor as JaxQT        # noqa: E402
from repro.runtime.serving import Request as JaxRequest      # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.runtime.static_runtime import \
    DispatchError as JaxDispatchError                        # noqa: E402
from repro.runtime.static_runtime import \
    StaticRuntime as JaxRuntime                              # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.interop import params_from_numpy            # noqa: E402
from repro_torch.kv.cache import (export_slot_kv,            # noqa: E402
                                  import_slot_kv)
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402
from repro_torch.runtime.static_runtime import DispatchError  # noqa: E402
from repro_torch.runtime.static_runtime import StaticRuntime  # noqa: E402

PROMPT_LEN = 8
CAP = 32
TICK_S = 5e-3            # fake time one program dispatch takes


# ---------------------------------------------------------------------------
# the shared fake clock and the side-by-side runner
# ---------------------------------------------------------------------------

class FakeClock:
    """Time that moves only when told: by ``TICK_S`` per program dispatch
    and by ``sleep``. It starts away from 0 (a 0 enqueue stamp reads as
    "not stamped yet")."""

    START = 1000.0

    def __init__(self):
        self.t = self.START

    def monotonic(self) -> float:
        return self.t

    def sleep(self, s: float):
        self.t += max(0.0, s)

    def restart(self):
        self.t = self.START


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port while this module runs: its
    engines are tiny, so one thread serves them about as fast and leaves
    the other cores to the suite's other workers (among them the JAX
    suite's chaos cases, which read the wall clock). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clock(monkeypatch):
    """One fake clock for both engines. The engines' and the fault
    harnesses' modules each get a ``time`` namespace of their own that
    reads it, and both runtimes' dispatch interceptors are wrapped so that
    every dispatch advances it by ``TICK_S`` before the installed hook (the
    injector's ``on_dispatch``, or none) runs. No engine knob and no edit
    to the JAX package: both engines keep calling ``time.monotonic`` and
    ``time.sleep``."""
    c = FakeClock()
    for mod in (jserving, jfaults, tserving, tfaults):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=c.monotonic, sleep=c.sleep))
    for cls in (JaxRuntime, StaticRuntime):
        def set_interceptor(self, fn, _orig=cls.set_interceptor):
            def tick(name):
                c.t += TICK_S
                if fn is not None:
                    fn(name)
            _orig(self, tick)
        monkeypatch.setattr(cls, "set_interceptor", set_interceptor)
    return c


def to_numpy_tree(tree):
    if isinstance(tree, JaxQT):
        return {"values": np.asarray(tree.values),
                "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree))


def make_models(**over):
    """Reduced f32 qwen2-0.5b on both sides with the same weights."""
    jcfg = ASSIGNED["qwen2-0.5b"].reduced().replace(dtype="float32", **over)
    tcfg = get_config("qwen2-0.5b").reduced().replace(dtype="float32",
                                                      **over)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(to_numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, japi, jparams, tapi, tparams


def numpy_cache(japi, rng, slots=3, length=24):
    """Random contents for a (slots, length) cache of ``japi``'s layout:
    int8 values in [-127, 127) with positive scales, or normal floats."""
    aval = japi.init_caches(slots, length)
    out = {}
    for n in ("k", "v", "k_scale", "v_scale"):
        a = getattr(aval, n)
        if a is None:
            out[n] = None
        elif a.dtype == jnp.int8:
            out[n] = rng.integers(-127, 127, a.shape).astype(np.int8)
        elif n.endswith("scale"):
            out[n] = rng.uniform(0.01, 1.0, a.shape).astype(np.float32)
        else:
            out[n] = rng.normal(size=a.shape).astype(np.float32)
    return out


def streams(reqs):
    return {r.rid: list(r.generated) for r in reqs}


def outcomes(reqs):
    return {r.rid: (r.status, r.reject_reason, r.preemptions,
                    list(r.generated)) for r in reqs}


COUNTERS = ("completed", "preemptions", "restores", "retries",
            "watchdog_timeouts", "quarantined_slots", "rejections",
            "deadline_misses", "host_syncs", "rejected", "decode_steps",
            "macro_steps", "admissions", "decode_tokens", "prefill_chunks",
            "per_request")


def program_calls(rt) -> dict:
    """Dispatches so far per program of a runtime (either side's)."""
    return {n: r["calls"] for n, r in rt.stats().items()}


def assert_same_stats(jstats, tstats, jcalls0, tcalls0):
    """Equal counters, per-request metrics and per-program calls of one
    run; ``*calls0``: each runtime's calls before the run (runtimes are
    shared between engines and runs)."""
    for key in COUNTERS:
        assert tstats[key] == jstats[key], key
    tcalls = {n: r["calls"] - tcalls0.get(n, 0)
              for n, r in tstats["runtime"].items()}
    assert tcalls == {n: r["calls"] - jcalls0.get(n, 0)
                      for n, r in jstats["runtime"].items()}
    for name, rec in tstats["runtime"].items():
        assert rec["compiles"] == 1, (name, rec)


def compare_runs(clock, jeng, jparams, jreqs, teng, tparams, treqs,
                 **kw):
    """Both engines serve their copy of one plan from the same fake time;
    statuses, reasons, streams, counters, per-request metrics and
    per-program calls must be equal. Returns (JAX stats, port stats)."""
    jcalls0, tcalls0 = program_calls(jeng.rt), program_calls(teng.rt)
    clock.restart()
    jstats = jeng.run(jparams, jreqs, **kw)
    clock.restart()
    tstats = teng.run(tparams, treqs, **kw)
    assert outcomes(treqs) == outcomes(jreqs)
    assert_same_stats(jstats, tstats, jcalls0, tcalls0)
    return jstats, tstats


@pytest.fixture(scope="module")
def dense():
    return make_models()


@pytest.fixture(scope="module")
def dense_int8():
    return make_models(kv_dtype="int8")


# ---------------------------------------------------------------------------
# the swap pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("valid", [0, 1, 11, 24])
@pytest.mark.parametrize("fixture", ["dense", "dense_int8"])
def test_swap_pair_matches_reference_bytes(fixture, valid, request):
    """Export slot 1 of a random cache on both sides (the same bytes), then
    import the image into slot 2 of another random cache at ``valid``: the
    images and the restored caches equal the reference's bit for bit, and
    the export leaves the cache as it was."""
    cfg, japi, _, tapi, _ = request.getfixturevalue(fixture)
    rng = np.random.default_rng(valid)
    src, dst = numpy_cache(japi, rng), numpy_cache(japi, rng)
    names = ("k", "v", "k_scale", "v_scale")

    jsrc, jdst = (japi.init_caches(3, 24)._replace(
        **{n: None if a[n] is None else jnp.asarray(a[n]) for n in names})
        for a in (src, dst))
    jsaved = jcache.export_slot_kv(jsrc, jnp.asarray(1, jnp.int32))
    jback = jcache.import_slot_kv(jdst, jsaved, jnp.asarray(2, jnp.int32),
                                  jnp.asarray(valid, jnp.int32))

    tsrc, tdst = (tapi.init_caches(3, 24) for _ in range(2))
    for c, a in ((tsrc, src), (tdst, dst)):
        for n in names:
            if a[n] is not None:
                getattr(c, n).copy_(torch.from_numpy(a[n]))
    before = {n: getattr(tsrc, n).clone() for n in names
              if src[n] is not None}
    tsaved = export_slot_kv(tsrc, 1)
    assert len(tsaved) == 6 and tsaved[4] is None and tsaved[5] is None
    for n in before:                                  # read-only
        assert torch.equal(getattr(tsrc, n), before[n])
    tback = import_slot_kv(tdst, tsaved, 2, valid)
    for i, n in enumerate(names):
        if src[n] is None:
            assert tsaved[i] is None and jsaved[i] is None
            continue
        assert tsaved[i].dtype == getattr(tsrc, n).dtype     # stored bytes
        np.testing.assert_array_equal(tsaved[i].numpy(),
                                      np.asarray(jsaved[i]), err_msg=n)
        np.testing.assert_array_equal(getattr(tback, n).numpy(),
                                      np.asarray(getattr(jback, n)),
                                      err_msg=n)
    assert int(tback.length) == int(jback.length)
    # the image is a copy: writing the cache after export leaves it as is
    tsrc.k.zero_()
    np.testing.assert_array_equal(tsaved[0].numpy(), np.asarray(jsaved[0]))


# ---------------------------------------------------------------------------
# preempt-then-restore through the engine
# ---------------------------------------------------------------------------

def _preempt_plan(cls, cfg, seed=3):
    """Two low-priority long decoders and one HIGH-priority late arrival:
    with 2 slots the arrival preempts a victim; with 3 nothing does."""
    rng = np.random.default_rng(seed)
    rs = [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, PROMPT_LEN,
                                         dtype=np.int32),
              max_new_tokens=20, arrival_step=0, priority=0)
          for i in range(2)]
    rs.append(cls(rid=2, prompt=rng.integers(0, cfg.vocab_size, 6,
                                             dtype=np.int32),
                  max_new_tokens=6, arrival_step=8, priority=5))
    return rs


# one runtime pair per program shape: engines that differ only in their
# policy knobs reuse the programs compiled for the first (compiling the
# reference's programs is most of a run's time here), and both sides keep
# the same program set
_RUNTIMES: dict = {}


def _engines(models, slots, *, T=8, chunk=4, a_shards=1, **kw):
    """The same engine on both sides (the reference's test settings)."""
    _, japi, _, tapi, _ = models
    jrt, trt = _RUNTIMES.setdefault((id(japi), slots, T, chunk, a_shards),
                                    (JaxRuntime(), StaticRuntime()))
    common = dict(mode="continuous", max_new_cap=CAP, block_size=T,
                  kv_bucket_chunk=16 if T > 1 else 0, prefill_chunk=chunk,
                  a_shards=a_shards)
    jkw = dict(kw)
    if "fault_injector" in kw:
        jkw["fault_injector"] = kw["fault_injector"]("jax")
        kw = dict(kw, fault_injector=kw["fault_injector"]("torch"))
    return (JaxEngine(japi, NULL_CTX, slots, PROMPT_LEN, runtime=jrt,
                      **common, **jkw),
            ServingEngine(tapi, slots, PROMPT_LEN, runtime=trt, device="cpu",
                          **common, **kw))


PREEMPT_CELLS = [
    ("dense", 1, 1),
    ("dense", 8, 1),
    ("dense", 1, 2),
    ("dense", 8, 2),
]


@pytest.mark.parametrize("fixture,T,a_shards", PREEMPT_CELLS)
def test_preempt_restore_token_identical(fixture, T, a_shards, clock,
                                         request):
    models = request.getfixturevalue(fixture)
    cfg, _, jparams, tapi, tparams = models
    base = _preempt_plan(Request, cfg)
    ServingEngine(tapi, 3, PROMPT_LEN, device="cpu", max_new_cap=CAP,
                  block_size=T, kv_bucket_chunk=16 if T > 1 else 0,
                  prefill_chunk=4, a_shards=a_shards).run(tparams, base,
                                                          max_steps=600)
    ref = streams(base)
    assert all(ref.values())

    jeng, teng = _engines(models, 2, T=T, a_shards=a_shards,
                          preemptible=True, strict_invariants=True)
    jreqs, treqs = _preempt_plan(JaxRequest, cfg), _preempt_plan(Request,
                                                                 cfg)
    calls0 = program_calls(teng.rt)
    _, tstats = compare_runs(clock, jeng, jparams, jreqs, teng, tparams,
                             treqs, max_steps=600)
    assert tstats["preemptions"] >= 1 and tstats["restores"] >= 1
    assert streams(treqs) == ref, "preempt-then-restore diverged"
    assert all(r.status == "completed" for r in treqs)
    calls1 = program_calls(teng.rt)
    first = {n: c - calls0.get(n, 0) for n, c in calls1.items()}
    assert first["serve_swap_out"] >= 1 and first["serve_swap_in"] >= 1
    # a second run of the engine registers nothing new and dispatches the
    # same programs as often
    again = teng.run(tparams, _preempt_plan(Request, cfg), max_steps=600)
    for name, rec in again["runtime"].items():
        assert rec["compiles"] == 1, (name, rec)
    assert {n: c - calls1[n] for n, c in program_calls(teng.rt).items()} \
        == first


def test_preempt_restore_int8_kv_token_identical(dense_int8, clock):
    """int8 KV through the swap (values and scales): the port's
    preempt-then-restore serve equals its uninterrupted serve at T=8 and
    two shards. The swap images are held against the reference's bytes
    above; the reference's int8 engine is not compiled here, which keeps
    the module light."""
    cfg, _, _, tapi, tparams = dense_int8
    common = dict(device="cpu", max_new_cap=CAP, block_size=8,
                  kv_bucket_chunk=16, prefill_chunk=4, a_shards=2)
    base = _preempt_plan(Request, cfg)
    ServingEngine(tapi, 3, PROMPT_LEN, **common).run(tparams, base,
                                                     max_steps=600)
    treqs = _preempt_plan(Request, cfg)
    stats = ServingEngine(tapi, 2, PROMPT_LEN, preemptible=True,
                          strict_invariants=True, **common).run(
                              tparams, treqs, max_steps=600)
    assert stats["preemptions"] >= 1 and stats["restores"] >= 1
    assert streams(treqs) == streams(base)
    assert all(r.status == "completed" for r in treqs)
    for name, rec in stats["runtime"].items():
        assert rec["compiles"] == 1, (name, rec)


# ---------------------------------------------------------------------------
# the reference's policy cases (tests/test_preemption.py), on both engines
# ---------------------------------------------------------------------------

def test_expired_ttft_deadline_sheds_as_deadline_missed(dense, clock):
    cfg, _, jparams, _, tparams = dense

    def plan(cls):
        rng = np.random.default_rng(0)
        slow = cls(rid=0, prompt=rng.integers(0, cfg.vocab_size, PROMPT_LEN,
                                              dtype=np.int32),
                   max_new_tokens=10, arrival_step=0)
        doomed = cls(rid=1, prompt=rng.integers(0, cfg.vocab_size, 4,
                                                dtype=np.int32),
                     max_new_tokens=4, arrival_step=0,
                     ttft_deadline_ms=1e-4)
        return [slow, doomed]

    jeng, teng = _engines(dense, 1)
    treqs = plan(Request)
    _, stats = compare_runs(clock, jeng, jparams, plan(JaxRequest), teng,
                            tparams, treqs, max_steps=400)
    slow, doomed = treqs
    assert slow.status == "completed" and len(slow.generated) == 10
    assert doomed.status == "deadline_missed"
    assert "ttft_deadline_ms" in doomed.reject_reason
    assert stats["deadline_misses"] == 1
    assert [e["rid"] for e in stats["rejected"]] == [1]


def test_bounded_queue_sheds_lowest_priority(dense, clock):
    cfg, _, jparams, _, tparams = dense

    def plan(cls):
        rng = np.random.default_rng(1)

        def mk(rid, arr, pri, new=6):
            return cls(rid=rid, prompt=rng.integers(
                0, cfg.vocab_size, PROMPT_LEN, dtype=np.int32),
                max_new_tokens=new, arrival_step=arr, priority=pri)
        return [mk(0, 0, 0, new=16), mk(1, 4, 2), mk(2, 4, 1), mk(3, 4, 0)]

    jeng, teng = _engines(dense, 1, max_queue=1)
    treqs = plan(Request)
    _, stats = compare_runs(clock, jeng, jparams, plan(JaxRequest), teng,
                            tparams, treqs, max_steps=400)
    first, late = treqs[0], treqs[1:]
    assert first.status == "completed"
    assert late[0].status == "completed"             # highest priority kept
    assert {r.status for r in late[1:]} == {"rejected"}
    assert all("queue_full" in r.reject_reason for r in late[1:])
    assert stats["rejections"] == 2 and stats["completed"] == 2


class _Scripted:
    """Fail the [start, stop) window of dispatches whose name contains one
    of ``targets`` (counting matching dispatches only), raising the given
    side's ``DispatchError``."""

    def __init__(self, error, targets, start, stop):
        self.error, self.targets = error, targets
        self.start, self.stop = start, stop
        self.matches = 0

    def on_dispatch(self, name):
        if not any(t in name for t in self.targets):
            return
        self.matches += 1
        if self.start <= self.matches - 1 < self.stop:
            raise self.error(f"scripted failure #{self.matches} for {name}")


def scripted(targets, start, stop):
    """Per-side factory: the JAX engine gets the reference's error type."""
    return lambda side: _Scripted(
        JaxDispatchError if side == "jax" else DispatchError, targets,
        start, stop)


def _two(cls, cfg, seed, new, priority=False):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, PROMPT_LEN,
                                           dtype=np.int32),
                max_new_tokens=new, arrival_step=0,
                priority=i if priority else 0) for i in range(2)]


def test_transient_dispatch_fault_absorbed_by_retry(dense, clock):
    """A fault window shorter than the retry budget shows only in the retry
    counter: every request completes with the clean run's tokens."""
    cfg, _, jparams, tapi, tparams = dense
    base = _two(Request, cfg, 2, 8)
    ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", max_new_cap=CAP,
                  block_size=8, kv_bucket_chunk=16,
                  prefill_chunk=4).run(tparams, base, max_steps=400)
    jeng, teng = _engines(dense, 2, max_retries=2,
                          fault_injector=scripted(["decode"], 1, 2))
    treqs = _two(Request, cfg, 2, 8)
    _, stats = compare_runs(clock, jeng, jparams, _two(JaxRequest, cfg, 2, 8),
                            teng, tparams, treqs, max_steps=400)
    assert stats["retries"] == 1 and stats["rejections"] == 0
    assert streams(treqs) == streams(base)


def test_persistent_dispatch_failure_demotes_not_hangs(dense, clock):
    """Four failing decode dispatches exhaust the retry budget: one victim
    is rejected (slot quarantined) and the survivor's tokens stay those of
    a clean run."""
    cfg, _, jparams, tapi, tparams = dense
    base = _two(Request, cfg, 4, 10, priority=True)
    ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", max_new_cap=CAP,
                  block_size=8, kv_bucket_chunk=16,
                  prefill_chunk=4).run(tparams, base, max_steps=400)
    ref = streams(base)
    jeng, teng = _engines(dense, 2, max_retries=2, strict_invariants=True,
                          fault_injector=scripted(["decode"], 1, 5))
    treqs = _two(Request, cfg, 4, 10, priority=True)
    _, stats = compare_runs(clock, jeng, jparams,
                            _two(JaxRequest, cfg, 4, 10, priority=True),
                            teng, tparams, treqs, max_steps=400)
    victim = next(r for r in treqs if r.status == "rejected")
    survivor = next(r for r in treqs if r.status == "completed")
    assert victim.reject_reason.startswith("dispatch_failed:serve_decode")
    assert stats["rejections"] == 1 and stats["quarantined_slots"]
    assert survivor.generated == ref[survivor.rid]


def test_failed_swap_out_leaves_victim_decoding(dense, clock):
    """Swap-out is read-only: when its dispatch keeps failing the
    preemption is abandoned and the victim keeps decoding."""
    cfg, _, jparams, tapi, tparams = dense
    base = _preempt_plan(Request, cfg)
    ServingEngine(tapi, 3, PROMPT_LEN, device="cpu", max_new_cap=CAP,
                  block_size=8, kv_bucket_chunk=16,
                  prefill_chunk=4).run(tparams, base, max_steps=600)
    jeng, teng = _engines(dense, 2, preemptible=True, max_retries=1,
                          strict_invariants=True,
                          fault_injector=scripted(["swap_out"], 0, 10_000))
    treqs = _preempt_plan(Request, cfg)
    _, stats = compare_runs(clock, jeng, jparams,
                            _preempt_plan(JaxRequest, cfg), teng, tparams,
                            treqs, max_steps=600)
    assert stats["preemptions"] == 0 and stats["restores"] == 0
    assert stats["retries"] > 0
    assert all(r.status == "completed" for r in treqs)
    assert streams(treqs) == streams(base)


@pytest.mark.parametrize("T", [1, 8])
def test_midblock_eos_then_preempted_readmission_race(dense, clock, T):
    """The victim is preempted for a high-priority request that halts
    mid-block; the freed slot restores the victim at the next admission
    point, and its decode must not read the other request's stale KV past
    its true length: streams equal an uninterrupted serve's and the JAX
    engine's."""
    cfg, _, jparams, tapi, tparams = dense

    def plan(cls):
        rng = np.random.default_rng(7)
        return [cls(rid=0, prompt=rng.integers(0, cfg.vocab_size, PROMPT_LEN,
                                               dtype=np.int32),
                    max_new_tokens=18, arrival_step=0, priority=0),
                cls(rid=1, prompt=rng.integers(0, cfg.vocab_size, 5,
                                               dtype=np.int32),
                    max_new_tokens=5, arrival_step=6, priority=3)]

    base = plan(Request)
    ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", max_new_cap=CAP,
                  block_size=T, kv_bucket_chunk=16 if T > 1 else 0,
                  prefill_chunk=4).run(tparams, base, max_steps=600)
    jeng, teng = _engines(dense, 1, T=T, preemptible=True,
                          strict_invariants=True)
    treqs = plan(Request)
    _, stats = compare_runs(clock, jeng, jparams, plan(JaxRequest), teng,
                            tparams, treqs, max_steps=600)
    assert stats["preemptions"] == 1 and stats["restores"] == 1
    assert streams(treqs) == streams(base)


# every remaining demotion path, scripted on both engines: (slots, chunk,
# targets, fail window, engine kwargs, expected reject reasons by rid)
DEMOTIONS = {
    "all_slots_quarantined": (
        1, 4, ["prefill_chunk"], (0, 10_000), dict(max_retries=1),
        {0: "dispatch_failed:serve_prefill_chunk",
         1: "no usable slots (all quarantined)",
         2: "no usable slots (all quarantined)"}),
    "failed_monolithic_admit": (
        2, 0, ["admit"], (0, 3), dict(max_retries=2),
        {0: "dispatch_failed:serve_admit"}),
    "failed_swap_in": (
        2, 4, ["swap_in"], (0, 10_000),
        dict(max_retries=1, preemptible=True),
        {0: "dispatch_failed:serve_swap_in"}),
    "failed_reset_quarantines": (
        2, 4, ["reset"], (0, 10_000),
        dict(max_retries=0, debug_reset_slots=True),
        {2: "no usable slots (all quarantined)"}),
}


@pytest.mark.parametrize("case", sorted(DEMOTIONS))
def test_demotion_paths_match_reference(dense, clock, case):
    """A dispatch that keeps failing ends in the reference's structured
    outcome on every path: a failed admission quarantines its slot (and,
    with none left, the rest is rejected), a failed restore rejects the
    preempted request, a failed debug reset quarantines its slot."""
    cfg, _, jparams, _, tparams = dense
    slots, chunk, targets, (start, stop), kw, reasons = DEMOTIONS[case]
    jeng, teng = _engines(dense, slots, chunk=chunk, strict_invariants=True,
                          fault_injector=scripted(targets, start, stop),
                          **kw)
    treqs = _preempt_plan(Request, cfg)
    _, stats = compare_runs(clock, jeng, jparams,
                            _preempt_plan(JaxRequest, cfg), teng, tparams,
                            treqs, max_steps=600)
    assert {r.rid: r.reject_reason for r in treqs
            if r.status == "rejected"} == reasons
    assert stats["rejections"] == len(reasons)
    assert stats["completed"] == len(treqs) - len(reasons)


# ---------------------------------------------------------------------------
# no fallback: only DispatchError is retried
# ---------------------------------------------------------------------------

class _Raise:
    def __init__(self, exc):
        self.exc = exc

    def on_dispatch(self, name):
        if "decode" in name:
            raise self.exc


@pytest.mark.parametrize("where", ["interceptor", "program"])
def test_other_errors_propagate_out_of_run(dense, where):
    """A RuntimeError that is not a DispatchError (what a CUDA error or a
    failed kernel build or launch raises) leaves ``run()`` as it was
    raised, on its first occurrence: nothing retried, rejected or
    quarantined."""
    cfg, _, _, tapi, tparams = dense
    boom = RuntimeError("CUDA error: an illegal memory access")
    eng = ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", max_new_cap=CAP,
                        block_size=8, prefill_chunk=4, preemptible=True,
                        max_retries=3,
                        fault_injector=_Raise(boom) if where == "interceptor"
                        else None)
    eng._prepare()
    step = eng.rt._steps["serve_decode_block"]
    calls = []
    if where == "program":
        def broken(*args):
            calls.append(1)
            raise boom
        step.fn = broken
    with pytest.raises(RuntimeError) as ei:
        eng.run(tparams, _two(Request, cfg, 5, 6), max_steps=400)
    assert ei.value is boom
    assert not isinstance(ei.value, DispatchError)
    assert eng._retries == 0 and not eng._rejected
    assert not eng._quarantined
    assert len(calls) == (1 if where == "program" else 0)


def test_failure_model_validation(dense):
    _, _, _, tapi, _ = dense
    with pytest.raises(ValueError, match="continuous scheduler"):
        ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", mode="drain",
                      preemptible=True)
    with pytest.raises(ValueError, match="max_retries"):
        ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", max_retries=-1)


def test_cli_preemptible_queue_and_chaos_on_cpu(clock, capsys):
    """``--preemptible --max-queue`` registers the swap pair and sheds the
    overflow as structured rejections; the chaos CLI runs its seeds green
    (on the fake clock, so deadlines do not depend on this host's load)."""
    serve_cli.main(["--device", "cpu", "--requests", "4", "--batch", "1",
                    "--prompt-len", "6", "--max-new", "4",
                    "--arrival-every", "0", "--block-size", "2",
                    "--prefill-chunk", "4", "--preemptible",
                    "--max-queue", "1"])
    out = capsys.readouterr().out
    assert "'completed': 1" in out and "rejections=3" in out
    assert out.count("reason=queue_full (max_queue=1)") == 3
    assert "serve_swap_out" in out and "serve_swap_in" in out
    assert tfaults._main(["--seeds", "2", "--device", "cpu"]) == 0
    assert "2/2 schedules green" in capsys.readouterr().out
