"""The enc-dec family (whisper) of the port against the JAX reference.

Reduced whisper-medium (2 encoder layers over 16 frames, 3 decoder layers,
d_model 128, 4 query heads on 2 KV heads of 32, LayerNorm, learned
positions, QKV biases, the ungated gelu_mlp FFN), weights made by the
reference and moved with ``interop``; numpy seeds make the tokens and the
frames.

- ``sinusoidal_pos`` and the non-causal full-sequence attention (Sq != Sk,
  the cross-attention's shape) hold to 1e-6 and 1e-5;
- ``encode``, then prefill with frames and 8 shared-cursor decode steps
  (4 with int8 weights),
  with the logits compared at every step and the self and cross caches at
  the end: in float32 within 1e-4 of max|logit| (tokens exact); in
  bfloat16 within 3e-2; with int8 weights and int8 KV (f32 compute) the
  stored int8 bytes and quantized activations are compared exactly and
  each step is held to 1e-4 until the first flip, 2e-2 after it, tokens
  exact (the rule of ``test_torch_model.py``); the cross K/V stay in the
  compute dtype there;
- the serving engine refuses the family with a ``ValueError`` where the
  reference engine fails the same plan with ``KeyError: 'frames'``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs.registry import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.models import attention as jattn                  # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.models import common as jcommon                   # noqa: E402
from repro.models import encdec as jed                       # noqa: E402
from repro.runtime.serving import Request as JaxRequest      # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.interop import (encdec_caches_from_numpy,   # noqa: E402
                                 params_from_numpy)
from repro_torch.models import attention as tattn            # noqa: E402
from repro_torch.models import common as tcommon             # noqa: E402
from repro_torch.models import encdec as ted                 # noqa: E402
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.runtime.serving import ServingEngine        # noqa: E402
from test_torch_model import (BF16_RTOL, INT8_FLIP_RTOL,     # noqa: E402
                              LOGIT_RTOL, act_flips, recorded_act_quant,
                              to_numpy_tree)

torch.set_num_threads(2)

ARCH = "whisper-medium"
P = 6            # prompt tokens
STEPS = 8        # decode steps


def _pair(**over):
    jcfg = JAX_REGISTRY[ARCH].reduced().replace(**over)
    tcfg = get_config(ARCH).reduced().replace(**over)
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
    frames = rng.standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return toks, frames


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(16, 128), (1500, 1024), (7, 10)])
def test_sinusoidal_pos_matches_reference(seq, d):
    """The sin half, then the cos half (concatenated, not interleaved).
    The angles reach ``seq``: the two sides may round an angle to
    neighbouring f32 values, one ulp of ``seq`` apart at most."""
    got = tcommon.sinusoidal_pos(seq, d)
    want = np.asarray(jcommon.sinusoidal_pos(seq, d))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=max(1e-6, seq * 2.0 ** -23))
    np.testing.assert_array_equal(got[0, :d // 2].numpy(), 0.0)
    np.testing.assert_array_equal(got[0, d // 2:].numpy(), 1.0)


@pytest.mark.parametrize("Sq,Sk,causal", [(5, 16, False), (16, 16, False),
                                          (9, 9, True), (4, 13, True)])
def test_full_sequence_attention_matches_reference(Sq, Sk, causal):
    """The encoder's and the cross-attention's non-causal form (Sq != Sk)
    and the causal form against ``flash_attention_padded``, f32."""
    rng = np.random.default_rng(Sq + Sk)
    q = rng.standard_normal((2, Sq, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 2, 32)).astype(np.float32)
    want = jattn.flash_attention_padded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 0,
        jattn.q_chunk_for(Sq), jattn.q_chunk_for(Sk))
    got = tattn.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_encode_matches_reference(models):
    jcfg, tcfg, _, jparams, _, tparams = models
    _, frames = _inputs(jcfg)
    want = jed.encode(jparams, jnp.asarray(frames), jcfg, NULL_CTX,
                      train=False)
    got = ted.encode(tparams, _t(frames), tcfg)
    close(got.numpy(), want, tokens=False)


# ---------------------------------------------------------------------------
# model programs
# ---------------------------------------------------------------------------

def kv_flips(jc, tc) -> int:
    """Stored int8 self-KV bytes that differ between the two caches (0
    for a float cache). With int8 weights too, a flipped activation moves
    a whole K/V row, so a byte may move by more than one step."""
    if jc.k_scale is None:
        return 0
    return sum(int((t.numpy() != np.asarray(j)).sum())
               for j, t in ((jc.k, tc.k), (jc.v, tc.v)))


def step_rtol(jc, tc, rec) -> float:
    """1e-4 while no stored byte and no quantized activation has flipped
    (counted exactly, cumulatively), 2e-2 after. Keeps the first K4 input
    that differs as ``rec["first"]``: (largest step, elements)."""
    for j, t in zip(rec["jax"], rec["torch"]):
        d = np.abs(t.reshape(j.shape).astype(np.int32) - j.astype(np.int32))
        if d.any() and "first" not in rec:
            rec["first"] = (int(d.max()), int((d > 0).sum()))
    flips = kv_flips(jc, tc) + act_flips(rec)
    return LOGIT_RTOL if flips == 0 else INT8_FLIP_RTOL


def _run_model(cfgs, rtol, rec=None, steps=STEPS):
    """Prefill with frames, then ``steps`` shared-cursor decode steps; both
    sides take the reference's tokens, the logits are compared at every
    step (tokens too when ``rtol`` is f32's; int8 steps after a flip at
    2e-2). Returns the two sides' caches."""
    jcfg, tcfg, japi, jparams, tapi, tparams = cfgs
    exact = rtol != BF16_RTOL
    toks, frames = _inputs(jcfg, seed=1)
    jc, jl = japi.prefill(jparams, {"tokens": jnp.asarray(toks),
                                    "frames": jnp.asarray(frames)}, NULL_CTX)
    tc, tl = tapi.prefill(tparams, _t(toks).long(), _t(frames))
    assert tc["self"].k.shape == jc["self"].k.shape == (
        jcfg.n_layers, 2, jcfg.n_kv_heads, P + 128, jcfg.head_dim)
    assert tc["cross"]["k"].shape == jc["cross"]["k"].shape
    r = step_rtol(jc["self"], tc["self"], rec) if rec is not None else rtol
    close(tl.float().numpy(), jl, r, exact)
    tok = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)
    jdec = jax.jit(lambda p, c, t: japi.decode(p, c, t, NULL_CTX)) \
        if rec is None else (lambda p, c, t: japi.decode(p, c, t, NULL_CTX))
    for _ in range(steps):
        jc, jl = jdec(jparams, jc, jnp.asarray(tok))
        tc, tl = tapi.decode(tparams, tc, _t(tok).long())
        r = step_rtol(jc["self"], tc["self"], rec) if rec is not None \
            else rtol
        close(tl.float().numpy(), jl, r, exact)
        tok = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)
    assert int(tc["self"].length) == int(jc["self"].length) == P + steps
    return jc, tc


def test_model_programs_match_reference(models):
    """f32: logits within 1e-4 of max|logit| at every step, tokens exact;
    the self and cross caches within 1e-4 of their largest magnitude."""
    jc, tc = _run_model(models, LOGIT_RTOL)
    for name in ("k", "v"):
        close(getattr(tc["self"], name).numpy(),
              getattr(jc["self"], name), tokens=False)
        close(tc["cross"][name].numpy(), jc["cross"][name], tokens=False)


def test_model_programs_match_reference_in_bfloat16():
    """bf16 weights and activations: logits within 3e-2 of max|logit| at
    every step (the two sides round in other orders, so tokens are not
    compared); the cross K/V within 3e-2."""
    cfgs = _pair(dtype="bfloat16")
    assert cfgs[5]["dec_blocks"][0]["xattn"]["wq"]["w"].dtype == \
        torch.bfloat16
    jc, tc = _run_model(cfgs, BF16_RTOL)
    assert tc["cross"]["k"].dtype == torch.bfloat16
    close(tc["cross"]["k"].float().numpy(),
          np.asarray(jc["cross"]["k"], np.float32), BF16_RTOL, tokens=False)


def test_model_programs_match_reference_int8_weights_and_kv(monkeypatch):
    """int8 weights (K4's plain version for every linear, the encoder's
    too) and int8 self KV, f32 compute: quantized activations and stored
    bytes compared exactly, a step held to 1e-4 until the first flip and
    to 2e-2 after it, tokens exact. The first K4 input that differs at
    all differs by one step in a few elements (a last-bit difference of
    the f32 sums rounded to neighbouring int8 steps); the flips then
    spread through the encoder. The cross K/V stay f32 (only the self KV
    is quantized). Four decode steps: the reference runs op by op here,
    to record its activations."""
    cfgs = _pair(dtype="float32", weight_int8=True, kv_dtype="int8")
    with recorded_act_quant(monkeypatch) as rec:
        jc, tc = _run_model(cfgs, LOGIT_RTOL, rec, steps=4)
    assert rec["total"] == 0 or (rec["first"][0] == 1
                                 and rec["first"][1] <= 4), rec.get("first")
    assert tc["self"].k.dtype == torch.int8
    assert tc["cross"]["k"].dtype == torch.float32
    assert jc["cross"]["k"].dtype == jnp.float32
    rtol = LOGIT_RTOL if rec["total"] == 0 else INT8_FLIP_RTOL
    close(tc["cross"]["v"].numpy(), jc["cross"]["v"], rtol, tokens=False)


def test_interop_loads_reference_caches(models):
    """A reference prefill's caches, moved with ``interop``, decode on the
    port to the reference's next logits."""
    jcfg, tcfg, japi, jparams, tapi, tparams = models
    toks, frames = _inputs(jcfg, seed=2)
    jc, jl = japi.prefill(jparams, {"tokens": jnp.asarray(toks),
                                    "frames": jnp.asarray(frames)}, NULL_CTX)
    s = jc["self"]
    tc = encdec_caches_from_numpy(
        {"self": {f: None if getattr(s, f) is None
                  else np.asarray(getattr(s, f))
                  for f in ("k", "v", "k_scale", "v_scale", "length")},
         "cross": {n: np.asarray(jc["cross"][n]) for n in ("k", "v")}},
        tcfg, device="cpu")
    tok = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)
    _, jl = japi.decode(jparams, jc, jnp.asarray(tok), NULL_CTX)
    _, tl = tapi.decode(tparams, tc, _t(tok).long())
    close(tl.numpy(), jl)


def test_model_api_has_no_slotted_fields(models):
    """As in the reference: prefill, decode and caches only."""
    tapi = models[4]
    assert tapi.decode_slotted is None and tapi.write_slot is None
    assert tapi.decode_block is None and tapi.prefill_chunk is None
    assert not tapi.wa_servable
    c = tapi.init_caches(3, 20)
    assert c["self"].k.shape[3] == 20
    assert c["cross"]["k"].shape == (3, 3, 2, 16, 32)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def test_engine_refuses_the_family(models):
    """The reference engine resolves ``auto`` to drain and then fails its
    drain prefill on the missing frames; the port refuses at
    construction."""
    jcfg, tcfg, japi, jparams, tapi, _ = models
    rng = np.random.default_rng(0)
    reqs = [JaxRequest(rid=i, prompt=rng.integers(0, jcfg.vocab_size, 8,
                                                  dtype=np.int32),
                       max_new_tokens=4) for i in range(2)]
    with pytest.raises(KeyError, match="frames"):
        JaxEngine(japi, NULL_CTX, 2, 8, max_new_cap=16).run(jparams, reqs)
    for kw in ({}, {"mode": "drain"}, {"mode": "continuous"}):
        with pytest.raises(ValueError, match="has no frames input.*"
                           "KeyError: 'frames'"):
            ServingEngine(tapi, 2, 8, device="cpu", **kw)
