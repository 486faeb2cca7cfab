"""The SSM family (Mamba-2 SSD) of the port against the JAX reference.

Reduced mamba2-1.3b (3 layers, d_model 128, 8 heads of 32, state 16,
chunk 16), float32 weights made by the reference and moved with
``interop``; numpy seeds make the inputs.

- the state functions (``causal_conv``, ``write_slot_tree``,
  ``reset_slot_tree``, ``mask_slots``, ``conv_step``'s window) give the
  reference's arrays exactly (``conv_step``'s output, an einsum in
  XLA's own summation order, to a few ulps), and ``mask_slots`` writes no
  inactive row;
- the SSD functions (``ssd_full_seq`` over a length no multiple of the
  chunk, ``ssd_final_state``, ``ssd_decode``, ``ssd_chunk`` with
  ``valid_len`` < C and the conv window carried across chunks) hold to
  1e-4 of the reference's largest magnitude;
- the model programs (prefill, ``decode_step``, ``decode_step_slotted``
  with an inactive row, which keeps its bytes, ``prefill_chunk``): logits
  within 1e-4 of max|logit| at every step, tokens exact; in bfloat16
  logits within 2e-2 of max|logit| and the f32 state within 5e-2;
- the engine against the JAX engine on one plan: continuous with T=4 and
  chunked prefill, T=1 with monolithic admission, and drain: streams,
  host syncs and per-program calls equal;
- the refusals (split-KV, preemption, WA, a KV budget) raise with the
  reference's messages, and a config with ``hot_window`` > 0 serves
  untiered, as in the reference.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs.registry import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.kv import state as jstate                         # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.models import ssm as jssm                         # noqa: E402
from repro.runtime.serving import Request as JaxRequest      # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.interop import (params_from_numpy,          # noqa: E402
                                 recurrent_state_from_numpy)
from repro_torch.kv import state as tstate                   # noqa: E402
from repro_torch.models import ssm as tssm                   # noqa: E402
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402
from test_torch_engine import to_numpy_tree                  # noqa: E402

torch.set_num_threads(2)

ARCH = "mamba2-1.3b"
RTOL = 1e-4
BF16_RTOL = 2e-2
# the f32 state after bf16 projections: the bf16 differences of every
# step's inputs accumulate in it
BF16_STATE_RTOL = 5e-2


def _pair(dtype="float32"):
    jcfg = JAX_REGISTRY[ARCH].reduced().replace(dtype=dtype)
    tcfg = get_config(ARCH).reduced().replace(dtype=dtype)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(to_numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, tcfg, japi, jparams, tapi, tparams


@pytest.fixture(scope="module")
def models():
    return _pair()


def _close(got, want, rtol=RTOL, tokens=True):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())
    if tokens:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


close = _close


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _state_np(st):
    return {"h": np.asarray(st.h), "conv": np.asarray(st.conv)}


# ---------------------------------------------------------------------------
# state functions: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_and_conv_step_equal_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy = jstate.causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    ty = tstate.causal_conv(_t(x).to(tdt), _t(w).to(tdt))
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    # conv_step: the new window exactly; y is the reference's einsum over
    # the 4 taps, a contraction whose summation order is XLA's own (no
    # fixed order reproduces it), so it holds to a few f32 ulps, and to
    # the bf16 rounding of that in bf16
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jy, jn = jstate.conv_step(jnp.asarray(st), jnp.asarray(x[:, 0], jdt),
                              jnp.asarray(w, jdt))
    ty, tn = tstate.conv_step(_t(st), _t(x[:, 0]).to(tdt), _t(w).to(tdt))
    np.testing.assert_allclose(
        ty.float().numpy(), np.asarray(jy.astype(jnp.float32)),
        rtol=1e-6 if dtype == "float32" else 8e-3, atol=1e-6)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_slot_tree_functions_equal_reference():
    """write_slot_tree, reset_slot_tree and mask_slots on an SSD-shaped
    state (L=3, B=4); mask_slots leaves inactive rows unwritten (the old
    tensors keep their storage and bytes) and with no row active writes
    nothing that changes a byte."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((3, 4, 2, 5, 6)).astype(np.float32)
    c = rng.standard_normal((3, 4, 3, 7)).astype(np.float32)
    h1 = rng.standard_normal((3, 1, 2, 5, 6)).astype(np.float32)
    c1 = rng.standard_normal((3, 1, 3, 7)).astype(np.float32)
    jst = jstate.RecurrentState(jnp.asarray(h), jnp.asarray(c))
    tst = tstate.RecurrentState(_t(h), _t(c))
    jw = jstate.write_slot_tree(
        jst, jstate.RecurrentState(jnp.asarray(h1), jnp.asarray(c1)),
        jnp.asarray(2))
    tw = tstate.write_slot_tree(tst, tstate.RecurrentState(_t(h1), _t(c1)),
                                2)
    assert tw is tst
    for a, b in ((tw.h, jw.h), (tw.conv, jw.conv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jr = jstate.reset_slot_tree(jw, jnp.asarray(1))
    tr = tstate.reset_slot_tree(tw, 1)
    for a, b in ((tr.h, jr.h), (tr.conv, jr.conv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    new_h = rng.standard_normal(h.shape).astype(np.float32)
    new_c = rng.standard_normal(c.shape).astype(np.float32)
    for act in ([True, False, True, False], [False] * 4, [True] * 4,
                [False, False, False, True]):
        act = np.array(act)
        old = tstate.RecurrentState(_t(h), _t(c))
        ptr = old.h.data_ptr()
        jm = jstate.mask_slots(jnp.asarray(act), jstate.RecurrentState(
            jnp.asarray(new_h), jnp.asarray(new_c)), jstate.RecurrentState(
            jnp.asarray(h), jnp.asarray(c)))
        tm = tstate.mask_slots(torch.from_numpy(act), tstate.RecurrentState(
            _t(new_h), _t(new_c)), old)
        assert tm is old and old.h.data_ptr() == ptr
        for a, b in ((tm.h, jm.h), (tm.conv, jm.conv)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mask_rows_never_writes_an_inactive_row():
    """The masked write touches only the active rows: an inactive row of
    the destination keeps even a NaN payload bit for bit."""
    old = torch.zeros(4, 3)
    old[1] = float("nan")
    new = torch.ones(4, 3)
    tstate.mask_rows(torch.tensor([True, False, False, True]), new, old, 0)
    assert torch.isnan(old[1]).all() and (old[[0, 3]] == 1).all() \
        and (old[2] == 0).all()


# ---------------------------------------------------------------------------
# SSD functions
# ---------------------------------------------------------------------------

def _layer(jparams, tparams, i=0):
    jp = jax.tree.map(lambda a: a[i], jparams["blocks"]["ssd"])
    return jp, tparams["blocks"][i]["ssd"]


def test_ssd_functions_match_reference(models):
    jcfg, tcfg, _, jparams, _, tparams = models
    jp, tp = _layer(jparams, tparams, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 45, jcfg.d_model)).astype(np.float32)
    close(tssm.ssd_full_seq(tp, _t(x), tcfg).numpy(),
          jssm.ssd_full_seq(jp, jnp.asarray(x), jcfg, NULL_CTX),
          tokens=False)
    jH, jc = jssm.ssd_final_state(jp, jnp.asarray(x), jcfg, NULL_CTX)
    tH, tc = tssm.ssd_final_state(tp, _t(x), tcfg)
    close(tH.numpy(), jH, tokens=False)
    close(tc.numpy(), jc, tokens=False)        # projections: matmul order
    x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jo, jH2, jc2 = jssm.ssd_decode(jp, jnp.asarray(x1), jcfg, NULL_CTX, jH,
                                   jc)
    to, tH2, tc2 = tssm.ssd_decode(tp, _t(x1), tcfg, tH, tc)
    close(to.numpy(), jo, tokens=False)
    close(tH2.numpy(), jH2, tokens=False)
    np.testing.assert_allclose(tc2.numpy(), np.asarray(jc2), rtol=1e-6,
                               atol=1e-6)


def test_ssd_chunk_carries_state_and_conv_across_chunks(models):
    """A 37-token sequence in chunks of 16 (the last one 5 valid
    positions): each chunk's output, end state and conv window against the
    reference's chained chunks, and the first chunk's conv bit for bit
    against the monolithic conv."""
    jcfg, tcfg, _, jparams, _, tparams = models
    jp, tp = _layer(jparams, tparams, 2)
    rng = np.random.default_rng(3)
    S, C = 37, 16
    x = rng.standard_normal((1, 48, jcfg.d_model)).astype(np.float32)
    d_in, nh, hd, N, G, W = tssm.dims(tcfg)
    jH = jnp.zeros((1, nh, hd, N), jnp.float32)
    jc = jnp.zeros((1, W - 1, d_in + 2 * G * N), jnp.float32)
    tH, tc = torch.zeros(jH.shape), torch.zeros(jc.shape)
    jfn = jax.jit(lambda *a: jssm.ssd_chunk(jp, *a[:1], jcfg, NULL_CTX,
                                            *a[1:]))
    for start in range(0, S, C):
        n = min(C, S - start)
        xc = x[:, start:start + C]
        jo, jH, jc = jfn(jnp.asarray(xc), jH, jc, jnp.asarray(n))
        to, tH, tc = tssm.ssd_chunk(tp, _t(xc), tcfg, tH, tc, n)
        close(to[:, :n].numpy(), np.asarray(jo)[:, :n], tokens=False)
        close(tH.numpy(), jH, tokens=False)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                                   atol=1e-6)
    # the state after the last partial chunk equals the monolithic one
    close(tH.numpy(), jssm.ssd_final_state(jp, jnp.asarray(x[:, :S]), jcfg,
                                           NULL_CTX)[0], tokens=False)


# ---------------------------------------------------------------------------
# model programs
# ---------------------------------------------------------------------------

def _run_model(cfgs, rtol):
    """Monolithic prefill of two rows, six shared-cursor steps, then six
    slotted steps with row 1 inactive (its state keeps its bytes), and a
    prompt of 21 tokens in chunks of 8 into slot 1. Both sides take the
    reference's tokens. In bf16 a near-tie may pick another argmax, so
    tokens are compared in f32 only."""
    exact = rtol == RTOL
    state_rtol = rtol if exact else BF16_STATE_RTOL

    def close(got, want, rtol, tokens=True):
        _close(got, want, rtol, tokens and exact)

    jcfg, tcfg, japi, jparams, tapi, tparams = cfgs
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 13), dtype=np.int32)
    jst, jl = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, NULL_CTX)
    tst, tl = tapi.prefill(tparams, _t(toks).long())
    close(tl.float().numpy(), jl, rtol)
    tok = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)
    jdec = jax.jit(lambda p, c, t: japi.decode(p, c, t, NULL_CTX))
    for _ in range(6):
        jst, jl = jdec(jparams, jst, jnp.asarray(tok))
        tst, tl = tapi.decode(tparams, tst, _t(tok).long())
        close(tl.float().numpy(), jl, rtol)
        tok = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)
    # slotted decode from the reference's state, row 1 inactive
    tst = recurrent_state_from_numpy(_state_np(jst), device="cpu")
    before = (tst.h[:, 1].clone(), tst.conv[:, 1].clone())
    act = np.array([True, False])
    pos = np.array([19, 19], np.int32)
    jslot = jax.jit(lambda *a: japi.decode_slotted(*a, NULL_CTX))
    for _ in range(6):
        jst, jl = jslot(jparams, jst, jnp.asarray(tok), jnp.asarray(pos),
                        jnp.asarray(act))
        tst, tl = tapi.decode_slotted(tparams, tst, _t(tok).long(),
                                      _t(pos), torch.from_numpy(act))
        close(tl[:1].float().numpy(), np.asarray(jl)[:1], rtol)
        tok = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)
        pos = pos + act
    assert torch.equal(tst.h[:, 1], before[0])
    assert torch.equal(tst.conv[:, 1], before[1])
    prompt = rng.integers(0, jcfg.vocab_size, 21, dtype=np.int32)
    jchunk = jax.jit(lambda *a: japi.prefill_chunk(*a, NULL_CTX))
    for start in range(0, 21, 8):
        n = min(8, 21 - start)
        row = np.zeros((1, 8), np.int32)
        row[0, :n] = prompt[start:start + n]
        jst, jl = jchunk(jparams, jst, jnp.asarray(row), jnp.asarray(1),
                         jnp.asarray(start), jnp.asarray(n))
        tst, tl = tapi.prefill_chunk(tparams, tst, _t(row).long(), 1, start,
                                     n)
        close(tl.float().numpy(), jl, rtol)
    close(tst.h.float().numpy(), jst.h, state_rtol, tokens=False)
    # the chunked prompt's state equals a monolithic prefill's
    jmono, _ = japi.prefill(jparams, {"tokens": jnp.asarray(prompt[None])},
                            NULL_CTX)
    close(tst.h[:, 1:2].float().numpy(), jmono.h, state_rtol, tokens=False)


def test_model_programs_match_reference(models):
    _run_model(models, RTOL)


def test_model_programs_match_reference_in_bfloat16():
    """bf16 weights and activations (the state stays f32): logits within
    2e-2 of max|logit| at every step (bf16 keeps 8 bits; the two sides
    round at the same points but sum in different orders, so a near-tie
    can pick another argmax: tokens are not compared); the f32 state
    within 5e-2 of its largest magnitude."""
    cfgs = _pair("bfloat16")
    assert cfgs[5]["blocks"][0]["ssd"]["A_log"].dtype == torch.float32
    assert cfgs[5]["blocks"][0]["ssd"]["x_proj"]["w"].dtype == \
        torch.bfloat16
    _run_model(cfgs, BF16_RTOL)


def test_decode_block_equals_slotted_steps(models):
    """The macro-step block (T=5) of the port gives the tokens of five
    slotted steps and leaves an inactive row's state unwritten."""
    jcfg, tcfg, japi, jparams, tapi, tparams = models
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (3, 9), dtype=np.int32)
    st, lg = tapi.prefill(tparams, _t(toks).long())
    twin = tstate.RecurrentState(st.h.clone(), st.conv.clone())
    tok = lg[:, -1].argmax(-1).to(torch.int32)
    pos = torch.full((3,), 9, dtype=torch.int32)
    act = torch.tensor([True, True, False])
    out = tapi.decode_block(tparams, st, tok, pos, act,
                            torch.tensor([5, 3, 5], dtype=torch.int32),
                            torch.full((3,), -1, dtype=torch.int32),
                            block_size=5)
    t, steps = tok, []
    a = act.clone()
    rem = torch.tensor([5, 3, 5], dtype=torch.int32)
    for _ in range(5):
        twin, lg = tapi.decode_slotted(tparams, twin, t, pos, a)
        t = torch.where(a, lg[:, 0].argmax(-1).to(torch.int32), 0)
        steps.append(t)
        rem = rem - a.to(torch.int32)
        a = a & (rem > 0)
    assert torch.equal(out[1], torch.stack(steps))
    assert torch.equal(st.h, twin.h) and torch.equal(st.conv, twin.conv)


# ---------------------------------------------------------------------------
# engine against the JAX engine
# ---------------------------------------------------------------------------

MONO = [(9, 0, 8), (13, 0, 8), (5, 2, 8), (9, 6, 8)]
RAGGED = [(9, 0, 6), (13, 0, 11), (5, 2, 8), (9, 6, 3)]
ENGINE_CASES = {
    # name: (plan, engine kwargs)
    "t4_chunk4": (RAGGED, dict(block_size=4, prefill_chunk=4)),
    "t1_mono": (MONO, dict(block_size=1)),
    "drain": (MONO, dict(mode="drain")),
}


def _requests(cls, vocab, plan, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, plen, dtype=np.int32),
                max_new_tokens=new, arrival_step=arr)
            for i, (new, arr, plen) in enumerate(plan)]


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_reference(models, case):
    jcfg, tcfg, japi, jparams, tapi, tparams = models
    plan, kw = ENGINE_CASES[case]
    jreqs = _requests(JaxRequest, jcfg.vocab_size, plan)
    jeng = JaxEngine(japi, NULL_CTX, 2, 8, max_new_cap=32, **kw)
    jstats = jeng.run(jparams, jreqs, max_steps=400)
    treqs = _requests(Request, jcfg.vocab_size, plan)
    teng = ServingEngine(tapi, 2, 8, device="cpu", max_new_cap=32, **kw)
    tstats = teng.run(tparams, treqs, max_steps=400)
    assert tstats["mode"] == jstats["mode"]
    assert tstats["completed"] == jstats["completed"] == len(plan)
    for a, b in zip(jreqs, treqs):
        assert b.generated == a.generated, a.rid
        assert b.admit_step == a.admit_step, a.rid
    assert teng.host_syncs == jeng.host_syncs
    for key in ("decode_steps", "macro_steps", "decode_tokens",
                "admissions", "prefill_chunks"):
        assert tstats[key] == jstats[key], key
    jrt = {k: v["calls"] for k, v in jstats["runtime"].items()}
    trt = {k: v["calls"] for k, v in tstats["runtime"].items()}
    assert trt == jrt
    if kw.get("block_size", 1) > 1:
        # no KV extent, so no buckets: one decode-block program
        assert "serve_decode_block" in trt and teng._ex.buckets == (0,)


def test_engine_admits_prompts_past_the_extent_with_chunks(models):
    """A recurrent state has no KV extent: chunked admission sets no
    length bound (a 60-token prompt with 30 new tokens on an extent of
    8 + 32), as in the reference."""
    jcfg, tcfg, japi, jparams, tapi, tparams = models
    plan = [(30, 0, 60), (4, 1, 5)]
    jreqs = _requests(JaxRequest, jcfg.vocab_size, plan, seed=3)
    jeng = JaxEngine(japi, NULL_CTX, 2, 8, max_new_cap=32, block_size=4,
                     prefill_chunk=8)
    jeng.run(jparams, jreqs, max_steps=400)
    treqs = _requests(Request, jcfg.vocab_size, plan, seed=3)
    teng = ServingEngine(tapi, 2, 8, device="cpu", max_new_cap=32,
                         block_size=4, prefill_chunk=8)
    assert teng._kv_extent is None
    teng.run(tparams, treqs, max_steps=400)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.host_syncs == jeng.host_syncs


REFUSALS = [
    (dict(a_shards=2), "requires a prefix-ordered"),
    (dict(preemptible=True), "requires a prefix-ordered"),
    (dict(backend="wa"), "ssm family has no WA-disaggregated"),
    (dict(kv_budget_bytes=10), "tiered-KV arbiter's pressure knob"),
    (dict(mode="drain", preemptible=True), "requires the continuous"),
]


@pytest.mark.parametrize("kw,match", REFUSALS)
def test_refusals_match_reference(models, kw, match):
    jcfg, tcfg, japi, _, tapi, _ = models
    with pytest.raises(ValueError, match=match):
        JaxEngine(japi, NULL_CTX, 2, 8, **kw)
    with pytest.raises(ValueError, match=match):
        ServingEngine(tapi, 2, 8, device="cpu", **kw)


def test_hot_window_serves_untiered_as_in_reference():
    """The reference builds an SSM state whatever ``hot_window`` says and
    serves it untiered (no arbiter, no ``tiered`` stats); so does the
    port."""
    jcfg = JAX_REGISTRY[ARCH].reduced().replace(dtype="float32",
                                                 hot_window=4)
    tcfg = get_config(ARCH).reduced().replace(dtype="float32", hot_window=4)
    jeng = JaxEngine(jax_build_model(jcfg), NULL_CTX, 2, 8)
    api = build_model(tcfg, device="cpu")
    teng = ServingEngine(api, 2, 8, device="cpu")
    assert teng.mode == jeng.mode == "continuous"
    assert teng._arbiter is None and jeng._arbiter is None
    reqs = _requests(Request, tcfg.vocab_size, MONO[:2])
    stats = teng.run(api.init(0), reqs, max_steps=200)
    assert stats["completed"] == 2 and "tiered" not in stats
