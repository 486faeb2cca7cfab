"""Preemption on a mesh of gloo ranks against the JAX reference on one
device (``NULL_CTX``), the same weights on both sides, reduced qwen2-0.5b in
float32 (``torch_mesh_tiered_ranks``):

- the swap pair on a rank's part: a flat f32 cache and tiered int8 and
  int4 caches filled with random bytes, cut on (1, 2) under all three
  executors (KV heads, or blocks of positions under +seqkv) and on (2, 1)
  (slots): the part ``export_slot_kv`` exports on the slot's data row is
  the rank's part of the reference's export of the whole cache, byte for
  byte, and importing it into a zeroed part restores exactly the
  positions below valid_len (global positions: 0, inside the first
  block, on the block edge, inside the second, all) and the ring
  verbatim, touching nothing else;
- priority preemption (a priority-5 arrival swaps a decoder out; on (2,
  1) it is restored into the slot of the other data row, its image moved
  rank to rank) and budget-pressure preemption (a byte budget of five hot
  tokens, three preemptions) through the colocated and the WA
  (``routing="sharding"``) engines on (1, 2) and (2, 1): token streams,
  statuses, per-request preemptions, admission steps, host syncs,
  ``serve_[wa_]swap_out/in`` and every other program's calls and
  ``stats()["tiered"]`` equal the JAX engine's on every rank;
- one seeded chaos schedule (``run_chaos``: injected dispatch failures,
  KV pressure answered by preemption, no deadline and no slowdown, so no
  clock is read) on (1, 2) and on (2, 1) over 4 slots (on (2, 1) an
  admission refused on one data row is replayed on the other): the
  report and the clean and chaos runs' outcomes equal on both ranks and
  equal the JAX engine's ``run_chaos``, with ``check_invariants`` green;
- the mesh refusals that stay (the overlap schedule, slots that do not
  divide over the data rows, an MoE over several data rows, monolithic
  admission under +seqkv) raise ``NotImplementedError`` with their reason,
  and preemption of the hybrid and the SSM families raises the reference
  engine's ``ValueError``.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import repro.kv.cache as jcache                              # noqa: E402
import repro.runtime.faults as jfaults                       # noqa: E402
import torch_mesh_tiered_ranks as ranks                      # noqa: E402
from repro.configs.registry import get_config as jget        # noqa: E402
from repro.models import NULL_CTX, build_model as jbuild     # noqa: E402
from repro.models import param_specs as jps                  # noqa: E402
from repro.models import sharding as jsh                     # noqa: E402
from repro.runtime.serving import Request as JRequest        # noqa: E402
from repro.runtime.serving import ServingEngine as JEngine   # noqa: E402
from repro_torch.launch.mesh import launch                   # noqa: E402
from test_torch_mesh import to_numpy_tree                    # noqa: E402
from test_torch_mesh_placement import _rules                 # noqa: E402
from test_torch_mesh_tiered import AXES, jcfg, local_part    # noqa: E402

torch.set_num_threads(1)

SWAP_SLOT = 1
VALID_LENS = (0, 5, 16, 23, 32)            # extent 32, blocks of 16 (+seqkv)
SWAP_CACHES = {"flat_f32": None, "tiered_int8": "int8",
               "tiered_int4": "int4"}
FIELDS = ("k", "v", "k_scale", "v_scale", "hot_k", "hot_v")


def filled_cache(cold, seed):
    """A reference cache (2 layers, 2 slots, 2 KV heads, 32 positions, hd
    8) filled with random stored bytes."""
    kw = dict(dtype=jnp.float32)
    if cold:
        kw.update(hot_window=ranks.HOT, cold_block=ranks.BLOCK,
                  cold_dtype=cold)
    jc = jcache.init_kv_cache(2, 2, 2, 32, 8, **kw)
    rng = np.random.default_rng(seed)
    bufs = {}
    for f in FIELDS:
        a = getattr(jc, f)
        if a is None:
            bufs[f] = None
        elif a.dtype == jnp.int8:
            bufs[f] = rng.integers(-128, 128, a.shape).astype(np.int8)
        else:
            bufs[f] = rng.uniform(0.01, 1.0, a.shape).astype(np.float32)
    return jc._replace(**{f: None if v is None else jnp.asarray(v)
                          for f, v in bufs.items()}), bufs


def ref_engine(cases, name, params):
    cold, plan, kw = ranks.engine_kwargs(cases, name)
    cfg = jcfg(cold)
    reqs = ranks.PLANS[plan](JRequest, cfg.vocab_size)
    eng = JEngine(jbuild(cfg), NULL_CTX, 2, ranks.PROMPT_LEN, **kw)
    st = eng.run(params, reqs, max_steps=1500)
    return outcome(eng, st, reqs)


def outcome(eng, st, reqs):
    return {"streams": [list(r.generated) for r in reqs],
            "statuses": [r.status for r in reqs],
            "reasons": [r.reject_reason for r in reqs],
            "preemptions": [r.preemptions for r in reqs],
            "admit_steps": [r.admit_step for r in reqs],
            "host_syncs": eng.host_syncs,
            "stats": {k: st[k] for k in ranks.COLD_ENGINE_KEYS},
            "calls": {k: v["calls"] for k, v in st["runtime"].items()},
            "tiered": st.get("tiered")}


def ref_chaos(params):
    cfg = jcfg("int8")
    plan = ranks.chaos_plan(jfaults.FaultPlan)
    reqs = plan.requests(cfg.vocab_size, prompt_lo=4,
                         prompt_hi=ranks.PROMPT_LEN + 8)
    eng = JEngine(jbuild(cfg), NULL_CTX, ranks.CHAOS_SLOTS,
                  ranks.PROMPT_LEN, **ranks.CHAOS_ENGINE)
    runs = []
    inner = eng.run

    def run(p, rs, **kw):
        st = inner(p, rs, **kw)
        runs.append(outcome(eng, st, rs))
        return st
    eng.run = run
    rep = jfaults.run_chaos(eng, params, plan, reqs)
    return {"report": rep, "clean": runs[0], "chaos": runs[1]}


def ref_refusals():
    """The reference engine's ValueError for preemption of the hybrid and
    the SSM families."""
    out = {}
    for arch in ("recurrentgemma-9b", "mamba2-1.3b"):
        cfg = jget(arch).reduced().replace(dtype="float32")
        with pytest.raises(ValueError) as e:
            JEngine(jbuild(cfg), NULL_CTX, 2, ranks.PROMPT_LEN,
                    max_new_cap=ranks.CAP, preemptible=True)
        out[arch] = str(e.value)
    return out


@pytest.fixture(scope="module")
def run():
    params = jax.jit(jbuild(jcfg()).init)(jax.random.key(31))
    tree = to_numpy_tree(params)
    caches = {key: filled_cache(cold, i)
              for i, (key, cold) in enumerate(SWAP_CACHES.items())}
    wholes = {key: (bufs, SWAP_CACHES[key])
              for key, (_, bufs) in caches.items()}
    handles = {shape: launch(ranks.preempt_rank, shape, AXES,
                             (tree, wholes, SWAP_SLOT, VALID_LENS),
                             timeout_s=300)
               for shape in ranks.EXECUTORS}
    try:
        ref = {"swap": {key: jcache.export_slot_kv(jc, SWAP_SLOT)
                        for key, (jc, _) in caches.items()},
               "engine": {name: ref_engine(ranks.PREEMPT_CASES, name,
                                           params)
                          for name in ranks.PREEMPT_CASES},
               "chaos": ref_chaos(params),
               "refusals": ref_refusals(),
               "caches": {key: jc for key, (jc, _) in caches.items()}}
    finally:
        res = {shape: h.join() for shape, h in handles.items()}
    return ref, res


MESH_CASES = [(shape, ex) for shape, exs in ranks.EXECUTORS.items()
              for ex in exs]


def _ids(shape, ex):
    return f"{'x'.join(map(str, shape))}-{ex}"


@pytest.mark.parametrize("key", sorted(SWAP_CACHES))
@pytest.mark.parametrize("shape, executor", MESH_CASES,
                         ids=[_ids(*c) for c in MESH_CASES])
def test_swap_pair_on_rank_parts(run, shape, executor, key):
    ref, res = run
    jc = ref["caches"][key]
    want = ref["swap"][key]
    fake = types.SimpleNamespace(shape=dict(zip(AXES, shape)))
    specs = jps.cache_specs(jc, jsh.ShardingCtx(
        fake, _rules(jsh, executor, False, False)))
    owners = 0
    for r in res[shape]:
        got = r["swap"][(executor, key)]
        if not got["owner"]:
            assert "export" not in got
            continue
        owners += 1
        for f, g, w in zip(FIELDS, got["export"], want):
            assert (g is None) == (w is None), f
            if g is None:
                continue
            spec = list(tuple(getattr(specs, f)))
            spec[1] = None                      # the exported slot
            np.testing.assert_array_equal(
                g, local_part(np.asarray(w), spec, got["coords"],
                              dict(zip(AXES, shape))), err_msg=f)
        assert got["imports"] == {n: (True, n) for n in VALID_LENS}
    # the slot's data row holds it: every rank of that row exports
    assert owners == shape[1]


ENGINE_CASES = [(shape, name) for shape in ranks.EXECUTORS
                for name in ranks.PREEMPT_CASES]


@pytest.mark.parametrize(
    "shape, name", ENGINE_CASES,
    ids=[f"{'x'.join(map(str, s))}-{n}" for s, n in ENGINE_CASES])
def test_preemption_equals_reference_engine(run, shape, name):
    ref, res = run
    want = ref["engine"][name]
    prefix = "serve_wa_" if name.startswith("wa") else "serve_"
    assert want["stats"]["completed"] == 3
    assert want["stats"]["preemptions"] >= 1
    assert want["calls"][prefix + "swap_out"] >= 1
    assert want["calls"][prefix + "swap_in"] == want["stats"]["restores"]
    for r in res[shape]:
        got = dict(r["engine"][name])
        mesh = got.pop("mesh")
        assert got == want
        assert mesh["shape"] == dict(zip(AXES, shape))


@pytest.mark.parametrize("shape", sorted(ranks.EXECUTORS),
                         ids=lambda s: "x".join(map(str, s)))
def test_chaos_schedule_on_mesh_equals_reference(run, shape):
    ref, res = run
    want = ref["chaos"]
    rep = want["report"]
    assert rep["violations"] == []
    assert rep["injected"]["injected_failures"] > 0
    assert rep["preemptions"] > 0
    for r in res[shape]:
        got = r["chaos"]
        assert got["report"] == rep
        for which in ("clean", "chaos"):
            g = dict(got[which])
            g.pop("mesh")
            assert g == want[which], which


REFUSALS = {
    (1, 2): {"overlap": "the overlap schedule",
             "monolithic_seqkv": "monolithic admission under a "
                                 "sequence-cut cache",
             "moe": None},
    (2, 1): {"overlap": "the overlap schedule",
             "slots": "3 slots over 2 data rows",
             "moe": "an MoE with more than one data row",
             "monolithic_seqkv": None},
}


@pytest.mark.parametrize("shape", sorted(REFUSALS),
                         ids=lambda s: "x".join(map(str, s)))
def test_refusals_on_mesh(run, shape):
    ref, res = run
    for r in res[shape]:
        got = r["refusals"]
        for key, why in REFUSALS[shape].items():
            if why is None:
                assert got[key] is None, key
                continue
            kind, msg = got[key]
            assert kind == "NotImplementedError", key
            assert f"does not run {why}" in msg, (key, msg)
        for arch, msg in ref["refusals"].items():
            assert got[arch] == ("ValueError", msg), arch
