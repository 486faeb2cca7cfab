"""MoE parity: the port's MoE family (``repro_torch.models.moe``, LayerNorm,
the MoE block through every program) against the JAX reference on the same
weights (``repro_torch.interop.params_from_numpy``), for
qwen3-moe-235b-a22b and phi3.5-moe-42b-a6.6b (LayerNorm) ``.reduced()``
(4 experts, top-2, expert width 64), in float32.

- ``moe_ffn`` at ``capacity_factor`` 0 (no drop) and 0.25 (capacity 8 for
  24 assignments an expert on average: most drop): the top-k sets and the
  kept assignments equal the reference's (the kept set of the reference is
  its own drop rule on its own routing, restated in numpy), output within
  1e-5 of max|out|, the load-balance loss within 1e-6; in bf16 (top-2,
  and top-8 of 16 experts), within 4 bf16 ulps of max|out|;
- LayerNorm and RMSNorm against the reference's ``apply_norm``;
- monolithic prefill + slot write, ``decode_step_slotted``, the decode
  block and ``prefill_chunk`` with flat f32 KV, int8 KV and int8 weights:
  tokens exact, logits within 1e-4 of max|logit| until a router top-k set,
  a stored int8 K/V step or a quantized activation differs between the
  sides (each recorded on both and counted exactly), 2e-2 after;
- the port's engine against the JAX engine (streams, admission steps,
  host syncs, per-program calls): colocated chunked and monolithic, WA at
  overlap 1 and 2 for both configurations, a tiered int4 cache (qwen3-moe)
  and split-KV over 2 shards (phi3.5-moe).
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib                                            # noqa: E402
import dataclasses                                           # noqa: E402

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import repro.models.common as jax_common                     # noqa: E402
import repro.models.moe as jmoe                              # noqa: E402
import repro_torch.kernels.gemv.ops as gemv_ops              # noqa: E402
import repro_torch.models.common as torch_common             # noqa: E402
import repro_torch.models.moe as tmoe                        # noqa: E402
from repro.configs.registry import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.quant.int8 import quantize_int8 as jax_quantize_int8  # noqa
from repro.runtime.serving import Request as JaxRequest      # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.interop import params_from_numpy            # noqa: E402
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402
from test_torch_model import (INT8_FLIP_RTOL, LOGIT_RTOL,    # noqa: E402
                              act_flips, to_numpy_tree)

torch.set_num_threads(2)

ARCHS = ("qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b")
P = 8            # prompt width
S = 40           # slot cache extent
KINDS = {"f32": {}, "f32_int8kv": dict(kv_dtype="int8"),
         "f32_w8": dict(weight_int8=True)}


def make_pair(arch, **over):
    jcfg = JAX_REGISTRY[arch].reduced().replace(dtype="float32", **over)
    tcfg = get_config(arch).reduced().replace(dtype="float32", **over)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(to_numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, japi, jparams, tcfg, tapi, tparams


@pytest.fixture(scope="module")
def pairs():
    """``pairs(arch, kind)`` -> make_pair(...), built once per module."""
    built = {}

    def get(arch, kind):
        if (arch, kind) not in built:
            built[arch, kind] = make_pair(arch, **KINDS[kind])
        return built[arch, kind]

    return get


@contextlib.contextmanager
def recorded_routing(monkeypatch):
    """Record the (T, K) expert ids every MoE layer routes to, on both
    sides, in call order: the reference's ``jax.lax.top_k`` through an
    ordered debug callback (it fires inside jitted programs and layer
    scans), the port's ``moe.route``."""
    rec = {"jax": [], "torch": [], "total": 0}
    top_k = jax.lax.top_k
    route = tmoe.route

    def jax_top_k(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda i: rec["jax"].append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx

    def torch_route(p, xf, k):
        out = route(p, xf, k)
        rec["torch"].append(out[2].numpy().copy())
        return out

    monkeypatch.setattr(jax.lax, "top_k", jax_top_k)
    monkeypatch.setattr(tmoe, "route", torch_route)
    yield rec


def router_flips(rec) -> int:
    """Token rows whose top-k expert set differs between the sides so far
    (cumulative: a flip changes every later layer's input)."""
    jax.effects_barrier()
    assert len(rec["jax"]) == len(rec["torch"]), \
        (len(rec["jax"]), len(rec["torch"]))
    for j, t in zip(rec["jax"], rec["torch"]):
        assert j.shape == t.shape
        rec["total"] += int((np.sort(j, -1) != np.sort(t, -1)).any(-1).sum())
    rec["jax"].clear()
    rec["torch"].clear()
    return rec["total"]


# ---------------------------------------------------------------------------
# moe_ffn and the norms
# ---------------------------------------------------------------------------

def _reference_keep(gate_idx: np.ndarray, E: int, C: int) -> np.ndarray:
    """The reference's drop rule restated in numpy: assignments in
    token-major order, stably sorted by expert, kept while their rank in
    their expert's segment is below C. -> (T, K) bool, token order."""
    flat = gate_idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty(flat.size, np.int64)
    for e in range(E):
        members = order[flat[order] == e]
        rank[members] = np.arange(members.size)
    return (rank < C).reshape(gate_idx.shape)


@pytest.mark.parametrize("cf", [0.0, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, cf, monkeypatch):
    jcfg = JAX_REGISTRY[arch].reduced().replace(dtype="float32")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=cf))
    tcfg = get_config(arch).reduced().replace(dtype="float32")
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                capacity_factor=cf))
    jp = jmoe.make_moe_params(jax.random.key(3), jcfg)
    stacked = jax.tree_util.tree_map(lambda a: a[None], to_numpy_tree(jp))
    tp = params_from_numpy({"blocks": {"moe": stacked}},
                           tcfg.replace(n_layers=1),
                           device="cpu")["blocks"][0]["moe"]
    x = np.random.default_rng(7).standard_normal((2, 24, 128)) \
        .astype(np.float32)
    T, E, K = 48, tcfg.moe.num_experts, tcfg.moe.experts_per_token
    C = tmoe.capacity(T, tcfg)
    assert C == jmoe.capacity(T, jcfg) == (T * K if cf <= 0 else 8)
    kept = []
    dispatch, route = tmoe.dispatch, tmoe.route

    def rec_dispatch(gate_idx, E_, C_):
        order, slot, keep = dispatch(gate_idx, E_, C_)
        tok = torch.empty_like(keep).index_copy_(0, order, keep)
        kept.append(tok.reshape(gate_idx.shape).numpy())
        return order, slot, keep

    monkeypatch.setattr(tmoe, "dispatch", rec_dispatch)
    with recorded_routing(monkeypatch) as rec:
        jo, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, NULL_CTX,
                                train=False)
        to = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
        jax.effects_barrier()
        jidx = rec["jax"][0]
        assert router_flips(rec) == 0
    want_keep = _reference_keep(jidx, E, C)
    np.testing.assert_array_equal(kept[0], want_keep)
    dropped = int((~want_keep).sum())
    assert (dropped == 0) if cf <= 0 else (dropped > T * K // 4)
    jo, to = np.asarray(jo), to.numpy()
    assert to.shape == jo.shape and to.dtype == np.float32
    assert np.abs(to - jo).max() <= 1e-5 * np.abs(jo).max()
    # the load-balance loss, which serving drops, from the port's router
    probs, _, tidx = route(tp, torch.from_numpy(x).reshape(T, -1), K)
    taux = tmoe.load_balance_loss(probs, tidx, E)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("E,K", [(4, 2), (16, 8)])
def test_moe_ffn_bf16_matches_reference(E, K):
    """bf16 serving's MoE (qwen3-moe reduced, no drop; top-2 as reduced
    and top-8 of 16 experts as at full width). The reference's
    scatter-add rounds to bf16 after each of a token's K adds, the port's
    gather rounds once after an f32 sum: up to K - 1 roundings of half an
    ulp apart, so within 4 bf16 ulps of max|out|."""
    o = dict(num_experts=E, experts_per_token=K, capacity_factor=0.0)
    arch = ARCHS[0]
    jcfg = JAX_REGISTRY[arch].reduced()
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **o))
    tcfg = get_config(arch).reduced()
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **o))
    assert tcfg.dtype == "bfloat16"
    jp = jmoe.make_moe_params(jax.random.key(3), jcfg)
    stacked = jax.tree_util.tree_map(lambda a: a[None], to_numpy_tree(jp))
    tp = params_from_numpy({"blocks": {"moe": stacked}},
                           tcfg.replace(n_layers=1),
                           device="cpu")["blocks"][0]["moe"]
    assert tp["router"]["w"].dtype == torch.float32
    x = np.random.default_rng(7).standard_normal((2, 24, 128)) \
        .astype(np.float32)
    jo, _ = jmoe.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), jcfg, NULL_CTX,
                         train=False)
    to = tmoe.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert to.dtype == torch.bfloat16
    jo, to = np.asarray(jo.astype(jnp.float32)), to.float().numpy()
    top = np.abs(jo).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.abs(to - jo).max() <= 4 * ulp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind, dtype):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 5, 128)) * 3 + 0.5).astype(np.float32)
    p = {"scale": rng.standard_normal(128).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(128).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want = jax_common.apply_norm(kind, {k: jnp.asarray(v, jdt)
                                        for k, v in p.items()},
                                 jnp.asarray(x, jdt), 1e-5)
    got = torch_common.apply_norm(kind, {k: torch.from_numpy(v).to(tdt)
                                         for k, v in p.items()},
                                  torch.from_numpy(x).to(tdt), 1e-5)
    assert got.dtype == tdt
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    tp = torch_common.make_norm(kind, 128, torch.float32, "cpu")
    jp = jax_common.make_norm(kind, 128, jnp.float32)
    assert set(tp) == set(jp)
    for k in tp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


# ---------------------------------------------------------------------------
# the model programs
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recorded_acts(monkeypatch):
    """Record the int8 activation rows every int8-weight linear multiplies,
    on both sides, in call order (``test_torch_model.recorded_act_quant``
    with the reference's rows taken by an ordered debug callback, so its
    programs stay jitted)."""
    rec = {"jax": [], "torch": [], "total": 0}
    jax_mm = jax_common.int8_matmul
    torch_k4 = gemv_ops.gemv_int8_q

    def jax_rec(x, w, out_dtype=jnp.bfloat16):
        jax.debug.callback(lambda v: rec["jax"].append(np.asarray(v)),
                           jax_quantize_int8(x, axis=-1).values,
                           ordered=True)
        return jax_mm(x, w, out_dtype=out_dtype)

    def torch_rec(xq, x_scale, wq, w_scale):
        rec["torch"].append(xq.numpy().copy())
        return torch_k4(xq, x_scale, wq, w_scale)

    monkeypatch.setattr(jax_common, "int8_matmul", jax_rec)
    monkeypatch.setattr(gemv_ops, "gemv_int8_q", torch_rec)
    yield rec


@pytest.fixture
def flips(monkeypatch):
    """Flip records of one test: router sets always, int8 activation rows
    too (none are made unless the config has int8 weights)."""
    with recorded_routing(monkeypatch) as routing, \
            recorded_acts(monkeypatch) as acts:
        yield {"routing": routing, "acts": acts}


def kv_flips(jc, tc) -> int:
    """Stored int8 K/V bytes that differ between the caches (0 for a float
    cache). Each must be one step. Once one differs, every later position
    of that row is computed from hidden states ~1e-3 apart, and their
    quantization lands on the other side of a rounding boundary for a few
    elements of every new row (35 of 15,360 after six steps of reduced
    phi3.5-moe, int8 KV), so the count is bounded at 1%, not at the
    flat-cache 0.1% of ``test_torch_model.int8_flips``."""
    if jc.k_scale is None:
        return 0
    n = 0
    for j, t in ((jc.k, tc.k), (jc.v, tc.v)):
        d = np.abs(t.numpy().astype(np.int32) - np.asarray(j).astype(np.int32))
        assert d.max() <= 1
        n += int((d > 0).sum())
    assert n <= 1e-2 * 2 * tc.k.numel(), n
    return n


def step_flips(jc, tc, rec) -> int:
    """Router, stored-KV and activation flips so far."""
    jax.effects_barrier()
    return (router_flips(rec["routing"]) + kv_flips(jc, tc)
            + act_flips(rec["acts"]))


def step_rtol(jc, tc, rec) -> float:
    return LOGIT_RTOL if step_flips(jc, tc, rec) == 0 else INT8_FLIP_RTOL


def assert_logits_close(got, want, rtol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def assert_cache_close(jc, tc, rtol):
    """Float K/V within ``rtol`` of their max (1e-4 before any flip);
    int8 K/V through ``kv_flips``."""
    for j, t in ((jc.k, tc.k), (jc.v, tc.v)):
        j, t = np.asarray(j, np.float32), t.to(torch.float32).numpy()
        if jc.k_scale is None:
            assert np.abs(t - j).max() <= rtol * np.abs(j).max()


def _prompts(cfg, n=2, width=P, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (n, width), dtype=np.int32)


def _admit_both(pair, prompts, fr):
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    jc = japi.init_caches(2, S)
    tc = tapi.init_caches(2, S)
    jl, tl = [], []
    for slot, row in enumerate(prompts):
        single, lg = japi.prefill(jparams, {"tokens": jnp.asarray(row[None])},
                                  NULL_CTX)
        jc = japi.write_slot(jc, single, slot)
        jl.append(np.asarray(lg[0, -1]))
        tsingle, tlg = tapi.prefill(tparams, torch.from_numpy(row[None]))
        tc = tapi.write_slot(tc, tsingle, slot)
        tl.append(tlg[0, -1].numpy())
        assert_logits_close(tl[-1], jl[-1], step_rtol(jc, tc, fr))
    return jc, tc, np.stack(jl), np.stack(tl)


CELLS = [(a, k) for a in ARCHS for k in sorted(KINDS)]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_decode_step_slotted_matches(pairs, arch, kind, flips):
    """Monolithic admission of two slots, then six slotted steps at bucket
    16 from a staggered state (row 1 two positions behind, inactive for
    two steps)."""
    pair = pairs(arch, kind)
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    jc, tc, jl, tl = _admit_both(pair, _prompts(jcfg, seed=1), flips)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    tok = jl.argmax(-1).astype(np.int32)
    pos = np.array([P, P - 2], np.int32)
    jstep = jax.jit(lambda *xs: japi.decode_slotted(*xs, NULL_CTX,
                                                    kv_bucket=16))
    for step in range(6):
        act = np.array([True, step >= 2])
        jc, jlg = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(pos),
                        jnp.asarray(act))
        tc, tlg = tapi.decode_slotted(
            tparams, tc, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(act), kv_bucket=16)
        jlg, tlg = np.asarray(jlg[:, 0]), tlg[:, 0].numpy()
        assert_logits_close(tlg[act], jlg[act], step_rtol(jc, tc, flips))
        nxt = jlg.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tlg.argmax(-1)[act], nxt[act])
        tok = np.where(act, nxt, 0).astype(np.int32)
        pos = pos + act.astype(np.int32)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


@pytest.mark.parametrize("arch,kind", CELLS)
def test_decode_block_matches(pairs, arch, kind, flips):
    """The macro-step block (T=8, bucket 16, row 1 halting after 5 tokens):
    tokens, emission bits, cursors, budgets and the stored cache."""
    pair = pairs(arch, kind)
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    jc, tc, jl, _ = _admit_both(pair, _prompts(jcfg, seed=2), flips)
    args = (jl.argmax(-1).astype(np.int32), np.full((2,), P, np.int32),
            np.array([True, True]), np.array([8, 5], np.int32),
            np.full((2,), -1, np.int32))
    jout = jax.jit(lambda *xs: japi.decode_block(
        *xs, NULL_CTX, block_size=8, kv_bucket=16))(
        jparams, jc, *[jnp.asarray(a) for a in args])
    tout = tapi.decode_block(tparams, tc, *[torch.from_numpy(a)
                                            for a in args],
                             block_size=8, kv_bucket=16)
    rtol = step_rtol(jout[0], tout[0], flips)
    for j, t in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert_cache_close(jout[0], tout[0], rtol)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_prefill_chunk_matches(pairs, arch, kind, flips):
    """An 11-token prompt in chunks of 4 into slot 1 (ragged last chunk):
    each chunk's logits and the slot's stored K/V; slot 0 untouched."""
    pair = pairs(arch, kind)
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    prompt = _prompts(jcfg, n=1, width=11, seed=3)[0]
    jc = japi.init_caches(2, S)
    tc = tapi.init_caches(2, S)
    jfn = jax.jit(lambda *xs: japi.prefill_chunk(*xs, NULL_CTX))
    for start in range(0, 11, 4):
        n = min(4, 11 - start)
        row = np.zeros((1, 4), np.int32)
        row[0, :n] = prompt[start:start + n]
        jc, jlg = jfn(jparams, jc, jnp.asarray(row),
                      jnp.asarray(1, jnp.int32),
                      jnp.asarray(start, jnp.int32),
                      jnp.asarray(n, jnp.int32))
        tc, tlg = tapi.prefill_chunk(tparams, tc, torch.from_numpy(row),
                                     1, start, n)
        rtol = step_rtol(jc, tc, flips)
        assert_logits_close(tlg[:, -1].numpy(), np.asarray(jlg[:, -1]),
                            rtol)
    assert not tc.k[:, 0].any()
    assert_cache_close(jc, tc, rtol)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

PLAN = [(9, 0), (13, 0), (5, 2), (9, 6), (7, 9), (6, 12)]
SLOTS = 4
CAP = 24
ENGINE_CELLS = {
    # id: (arch, config overrides, engine kwargs)
    **{f"{a[:4]}-colocated-chunk3-t8-buckets": (
        a, {}, dict(block_size=8, prefill_chunk=3, kv_bucket_chunk=16))
       for a in ARCHS},
    **{f"{a[:4]}-colocated-mono-t8": (a, {}, dict(block_size=8))
       for a in ARCHS},
    **{f"{a[:4]}-wa-d{D}-chunk3-t8": (a, {}, dict(
        block_size=8, prefill_chunk=3, backend="wa", overlap=D))
       for a in ARCHS for D in (1, 2)},
    "qwen-tiered-int4-chunk4-t8": (
        ARCHS[0], dict(hot_window=4, kv_cold_dtype="int4", kv_cold_block=4),
        dict(block_size=8, prefill_chunk=4)),
    "phi3-int8kv-shards2-chunk3-t8": (
        ARCHS[1], dict(kv_dtype="int8"),
        dict(block_size=8, prefill_chunk=3, a_shards=2)),
}


def _requests(cls, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, P, dtype=np.int32),
                max_new_tokens=new, arrival_step=arr)
            for i, (new, arr) in enumerate(PLAN)]


@pytest.mark.parametrize("cell", sorted(ENGINE_CELLS))
def test_engine_matches_reference(pairs, cell):
    """Streams, admission steps, host syncs, counters and per-program calls
    equal the JAX engine's on the same f32 weights (the program tests'
    models where a cell has their overrides)."""
    arch, over, kw = ENGINE_CELLS[cell]
    kind = next((k for k, v in KINDS.items() if v == over), None)
    pair = make_pair(arch, **over) if kind is None else pairs(arch, kind)
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    kw = dict(mode="continuous", max_new_cap=CAP, **kw)
    jreqs = _requests(JaxRequest, jcfg.vocab_size)
    jeng = JaxEngine(japi, NULL_CTX, SLOTS, P, **kw)
    jstats = jeng.run(jparams, jreqs, max_steps=400)
    treqs = _requests(Request, tcfg.vocab_size)
    teng = ServingEngine(tapi, SLOTS, P, device="cpu", **kw)
    tstats = teng.run(tparams, treqs, max_steps=400)
    assert tstats["completed"] == jstats["completed"] == len(PLAN)
    for a, b in zip(jreqs, treqs):
        assert b.generated == a.generated, (cell, a.rid)
        assert b.admit_step == a.admit_step, (cell, a.rid)
    assert teng.host_syncs == jeng.host_syncs
    for key in ("decode_steps", "macro_steps", "decode_tokens",
                "prefill_chunks", "admissions", "overlapped_admissions",
                "backend"):
        assert tstats[key] == jstats[key], key
    jrt, trt = jstats["runtime"], tstats["runtime"]
    assert set(trt) == set(jrt)
    for name in trt:
        assert trt[name]["compiles"] == 1
        assert trt[name]["calls"] == jrt[name]["calls"], name
    if "tiered" in jstats:
        assert tstats["tiered"] == jstats["tiered"]
        assert tstats["tiered"]["demotions"] > 0
    if kw.get("backend") == "wa":
        for key in ("routing_bytes_per_token", "routing_total_bytes",
                    "overlap", "overlap_efficiency", "schedule_ticks"):
            assert tstats["wa"][key] == jstats["wa"][key], key
