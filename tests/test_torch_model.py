"""Model parity: the port's dense transformer against the JAX reference on
the same weights (``repro_torch.interop.params_from_numpy``).

Covers slotted decode (full extent and KV-bucketed), the macro-step decode
block, chunked prefill and monolithic prefill + slot write, for three f32
configs: flat f32 KV, int8 KV and int8 weights. Logits must agree at every
step within 1e-4 * max|logit| and tokens exactly. The reduced qwen2 fixture
decodes a near-constant stream, so the logit check carries the weight.

A bf16 case runs at a looser tolerance: the reference rounds the softmax
weights to bf16 before the PV product and ``silu(gate)`` before the FFN
multiply, where the port's kernels (and their plain versions) keep f32.
"""
import pytest

torch = pytest.importorskip("torch")

import contextlib                                            # noqa: E402

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

from repro.configs.registry import ASSIGNED                  # noqa: E402
from repro.models import NULL_CTX                            # noqa: E402
from repro.models import build_model as jax_build_model      # noqa: E402
from repro.models.registry import count_params as jax_count_params  # noqa
import repro.models.common as jax_common                     # noqa: E402
import repro_torch.kernels.gemv.ops as gemv_ops              # noqa: E402
import repro_torch.models.common as torch_common             # noqa: E402
from repro.quant.int8 import QuantizedTensor as JaxQT        # noqa: E402
from repro.quant.int8 import quantize_int8 as jax_quantize_int8  # noqa
from repro_torch.configs.registry import get_config          # noqa: E402
import repro.kv.cache as jax_cache                            # noqa: E402
from repro_torch.interop import (kv_cache_from_numpy,        # noqa: E402
                                 params_from_numpy)
from repro_torch.kv.cache import (batch_valid_mask,          # noqa: E402
                                  layer_read_bucket, slot_valid_mask)
from repro_torch.models.registry import build_model, count_params  # noqa

torch.set_num_threads(2)

P = 8            # prompt width
S = 40           # slot cache extent
LOGIT_RTOL = 1e-4
BF16_RTOL = 3e-2
# int8 KV and int8 weights: XLA and PyTorch sum in different orders, so an
# f32 value a last bit apart can round to the neighbouring int8 step. Each
# such flip moves one stored K/V element or one quantized activation by one
# step (1/127 of its row's max), and later layers carry the change on. A
# step reached after any flip (counted exactly: stored bytes are compared,
# quantized activations recorded on both sides) is held to 2e-2 *
# max|logit| and exact tokens; every other step to LOGIT_RTOL.
INT8_FLIP_RTOL = 2e-2


def to_numpy_tree(tree):
    """JAX pytree -> nested dicts of numpy (bf16 as exact f32)."""
    if isinstance(tree, JaxQT):
        return {"values": np.asarray(tree.values),
                "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    a = jnp.asarray(tree)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def cache_to_numpy(c):
    return {"k": to_numpy_tree(c.k), "v": to_numpy_tree(c.v),
            "k_scale": None if c.k_scale is None else np.asarray(c.k_scale),
            "v_scale": None if c.v_scale is None else np.asarray(c.v_scale),
            "length": np.asarray(c.length)}


def assert_logits_close(got, want, rtol=LOGIT_RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def int8_flips(jc, tc) -> int:
    """Stored int8 K/V bytes that differ between the two caches (0 for a
    float cache); asserts flips are rare and one step each."""
    if jc.k_scale is None:
        return 0
    n = 0
    for j, t in ((jc.k, tc.k), (jc.v, tc.v)):
        d = np.abs(t.numpy().astype(np.int32) - np.asarray(j).astype(np.int32))
        assert d.max() <= 1
        n += int((d > 0).sum())
    assert n <= 1e-3 * 2 * tc.k.numel(), n
    return n


@contextlib.contextmanager
def recorded_act_quant(monkeypatch):
    """Record the int8 activation rows every int8-weight linear multiplies,
    on both sides, in call order (the JAX side then runs eagerly). The port
    quantizes a shared input once (q/k/v, gate/up), so its rows are
    recorded per K4 call, where the reference quantizes per linear."""
    rec = {"jax": [], "torch": [], "total": 0}
    jax_mm = jax_common.int8_matmul
    torch_k4 = gemv_ops.gemv_int8_q

    def jax_rec(x, w, out_dtype=jnp.bfloat16):
        rec["jax"].append(np.asarray(jax_quantize_int8(x, axis=-1).values))
        return jax_mm(x, w, out_dtype=out_dtype)

    def torch_rec(xq, x_scale, wq, w_scale):
        rec["torch"].append(xq.numpy().copy())
        return torch_k4(xq, x_scale, wq, w_scale)

    monkeypatch.setattr(jax_common, "int8_matmul", jax_rec)
    monkeypatch.setattr(gemv_ops, "gemv_int8_q", torch_rec)
    with jax.disable_jit():
        yield rec


def act_flips(rec) -> int:
    """Quantized activations that differ so far (cumulative: a flip in a
    prefill changes the K/V every later step attends)."""
    assert len(rec["jax"]) == len(rec["torch"])
    for j, t in zip(rec["jax"], rec["torch"]):
        rec["total"] += int((t.reshape(j.shape) != j).sum())
    rec["jax"].clear()
    rec["torch"].clear()
    return rec["total"]


def step_rtol(jc, tc, rec=None) -> float:
    flips = int8_flips(jc, tc) + (act_flips(rec) if rec else 0)
    return LOGIT_RTOL if flips == 0 else INT8_FLIP_RTOL


def make_pair(**over):
    jcfg = ASSIGNED["qwen2-0.5b"].reduced().replace(**over)
    tcfg = get_config("qwen2-0.5b").reduced().replace(**over)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(to_numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, japi, jparams, tcfg, tapi, tparams


CONFIGS = {
    "f32": dict(dtype="float32"),
    "f32_int8kv": dict(dtype="float32", kv_dtype="int8"),
    "f32_w8": dict(dtype="float32", weight_int8=True),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return make_pair(**CONFIGS[request.param])


@pytest.fixture
def rec(pair, monkeypatch):
    """Activation-flip recorder for the int8-weight config, else None."""
    if not pair[0].weight_int8:
        yield None
        return
    with recorded_act_quant(monkeypatch) as r:
        yield r


def _prompts(cfg, n=2, width=P, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (n, width), dtype=np.int32)


def _admit_both(pair, prompts):
    """Monolithic prefill of each prompt into its slot of a (2, S) cache on
    both sides; returns caches and first-token logits."""
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
    return jc, tc, np.stack(jl), np.stack(tl)


def test_param_count_matches_reference(pair):
    jcfg, _, jparams, tcfg, _, tparams = pair
    assert count_params(tcfg) == jax_count_params(jcfg)
    full_t = get_config("qwen2-0.5b")
    assert count_params(full_t) == jax_count_params(ASSIGNED["qwen2-0.5b"])


def test_prefill_and_write_slot_match(pair, rec):
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    jc, tc, jl, tl = _admit_both(pair, _prompts(jcfg))
    assert_logits_close(tl, jl, step_rtol(jc, tc, rec))
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    if jc.k_scale is not None:          # stored int8 bytes: rare 1-step flips
        int8_flips(jc, tc)
    else:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bucket", [0, 16])
def test_decode_step_slotted_matches(pair, bucket, rec):
    """Six slotted steps from a staggered state: row 1 sits two positions
    behind row 0 and is inactive for the first two steps. Logits of active
    rows and tokens match at every step."""
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    jc, tc, jl, tl = _admit_both(pair, _prompts(jcfg, seed=1))
    assert_logits_close(tl, jl, step_rtol(jc, tc, rec))
    tok = jl.argmax(-1).astype(np.int32)
    pos = np.array([P, P - 2], np.int32)
    jstep = jax.jit(lambda *xs: japi.decode_slotted(*xs, NULL_CTX,
                                                    kv_bucket=bucket))
    for step in range(6):
        act = np.array([True, step >= 2])
        jc, jlg = jstep(jparams, jc, jnp.asarray(tok), jnp.asarray(pos),
                        jnp.asarray(act))
        tc, tlg = tapi.decode_slotted(
            tparams, tc, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(act), kv_bucket=bucket)
        jlg = np.asarray(jlg[:, 0])
        tlg = tlg[:, 0].numpy()
        assert_logits_close(tlg[act], jlg[act], step_rtol(jc, tc, rec))
        nxt = jlg.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tlg.argmax(-1)[act], nxt[act])
        tok = np.where(act, nxt, 0).astype(np.int32)
        pos = pos + act.astype(np.int32)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_decode_block_matches(pair, rec):
    """The macro-step block (T=8, row 1 halts after 5 tokens) against the
    JAX block: tokens, emission bits, cursors, budgets and the stored
    cache."""
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    jc, tc, jl, _ = _admit_both(pair, _prompts(jcfg, seed=2))
    args = (jl.argmax(-1).astype(np.int32), np.full((2,), P, np.int32),
            np.array([True, True]), np.array([8, 5], np.int32),
            np.full((2,), -1, np.int32))
    jout = jax.jit(lambda *xs: japi.decode_block(
        *xs, NULL_CTX, block_size=8, kv_bucket=16))(
        jparams, jc, *[jnp.asarray(a) for a in args])
    tout = tapi.decode_block(tparams, tc, *[torch.from_numpy(a)
                                            for a in args],
                             block_size=8, kv_bucket=16)
    for j, t in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jk = np.asarray(jout[0].k, np.float32)
    tk = tout[0].k.to(torch.float32).numpy()
    if jout[0].k_scale is None:
        np.testing.assert_allclose(tk, jk, rtol=1e-4, atol=1e-5)
    else:
        int8_flips(jout[0], tout[0])


def test_prefill_chunk_matches(pair, rec):
    """An 11-token prompt walked in chunks of 4 into slot 1 (ragged final
    chunk): final-chunk logits and the slot's stored K/V match; slot 0 and
    positions past the prompt stay untouched."""
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    prompt = _prompts(jcfg, n=1, width=11, seed=3)[0]
    jc = japi.init_caches(2, S)
    tc = tapi.init_caches(2, S)
    jfn = jax.jit(lambda *xs: japi.prefill_chunk(*xs, NULL_CTX))
    C = 4
    for start in range(0, 11, C):
        n = min(C, 11 - start)
        row = np.zeros((1, C), np.int32)
        row[0, :n] = prompt[start:start + n]
        jc, jlg = jfn(jparams, jc, jnp.asarray(row), jnp.asarray(1, jnp.int32),
                      jnp.asarray(start, jnp.int32), jnp.asarray(n, jnp.int32))
        tc, tlg = tapi.prefill_chunk(tparams, tc, torch.from_numpy(row), 1,
                                     start, n)
        assert_logits_close(tlg[:, -1].numpy(), np.asarray(jlg[:, -1]),
                            step_rtol(jc, tc, rec))
    assert not tc.k[:, 0].any()
    assert not tc.k[:, 1, :, 11:].any()
    if jc.k_scale is not None:
        int8_flips(jc, tc)
    else:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_kv_cache_from_numpy_roundtrip_and_reads(pair):
    """The cache bridge is exact, and the port's bucketed layer read and
    masks equal the reference's on the same stored bytes."""
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    jc, _, _, _ = _admit_both(pair, _prompts(jcfg, seed=4))
    tc = kv_cache_from_numpy(cache_to_numpy(jc), tcfg, device="cpu")
    np.testing.assert_array_equal(tc.k.to(torch.float32).numpy(),
                                  np.asarray(jc.k, np.float32))
    assert (tc.k_scale is None) == (jc.k_scale is None)
    assert int(tc.length) == int(jc.length)
    for bucket in (0, 16, 64):
        jk, jv = jax_cache.layer_read_bucket(
            jc.k[1], jc.v[1], None if jc.k_scale is None else jc.k_scale[1],
            None if jc.v_scale is None else jc.v_scale[1], bucket,
            dtype=jnp.float32)
        tk, tv = layer_read_bucket(*tc.layer(1), bucket, dtype=torch.float32)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    pos = np.array([0, 5, 39], np.int32)
    np.testing.assert_array_equal(
        batch_valid_mask(S, torch.from_numpy(pos)).numpy(),
        np.asarray(jax_cache.batch_valid_mask(S, 0, jnp.asarray(pos))))
    np.testing.assert_array_equal(
        slot_valid_mask(S, 7).numpy(),
        np.asarray(jax_cache.slot_valid_mask(S, 0, jnp.asarray(7))))


def test_int8_shared_quantization_bit_identical(monkeypatch):
    """int8 weights: quantizing the shared input of q/k/v and of gate/up
    once gives the same bits as quantizing it once per linear (the
    reference's way), matches the JAX reference, and keeps 7 K4 calls per
    layer and decode step."""
    pair = make_pair(**CONFIGS["f32_w8"])
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    prompts = _prompts(jcfg, seed=6)
    tok = torch.zeros(2, dtype=torch.int32)
    pos = torch.full((2,), P, dtype=torch.int32)
    act = torch.ones(2, dtype=torch.bool)

    def run():
        calls = []
        k4 = gemv_ops.gemv_int8_q
        with monkeypatch.context() as m:
            m.setattr(gemv_ops, "gemv_int8_q",
                      lambda *a: calls.append(1) or k4(*a))
            tc = tapi.init_caches(2, S)
            for slot, row in enumerate(prompts):
                single, lg = tapi.prefill(tparams, torch.from_numpy(row[None]))
                tc = tapi.write_slot(tc, single, slot)
            n0 = len(calls)
            tc, dlg = tapi.decode_slotted(tparams, tc, tok, pos, act)
        return lg, dlg, tc, len(calls) - n0

    shared = run()

    shared_linears = torch_common.linears

    def per_linear(ps, x, out_dtype=None):
        return [shared_linears([p], x, out_dtype)[0] for p in ps]

    with monkeypatch.context() as m:
        m.setattr(torch_common, "linears", per_linear)
        ref = run()
    for a, b in ((shared[0], ref[0]), (shared[1], ref[1]),
                 (shared[2].k, ref[2].k), (shared[2].v, ref[2].v)):
        assert torch.equal(a, b)
    assert shared[3] == ref[3] == 7 * tcfg.n_layers
    with recorded_act_quant(monkeypatch) as rec:
        jc, tc, jl, tl = _admit_both(pair, prompts)
        assert_logits_close(tl, jl, step_rtol(jc, tc, rec))
    np.testing.assert_array_equal(tl[-1], shared[0][0, -1].numpy())


def test_bf16_decode_within_stated_tolerance():
    """bf16 at a looser tolerance (3e-2 * max|logit|): the reference rounds
    the softmax weights and silu(gate) to bf16 where the port keeps f32."""
    pair = make_pair()
    jcfg, japi, jparams, tcfg, tapi, tparams = pair
    jc, tc, jl, tl = _admit_both(pair, _prompts(jcfg, seed=5))
    assert_logits_close(tl, jl, BF16_RTOL)
    tok = jl.argmax(-1).astype(np.int32)
    pos = np.full((2,), P, np.int32)
    act = np.array([True, True])
    for _ in range(3):
        jc, jlg = japi.decode_slotted(jparams, jc, jnp.asarray(tok),
                                      jnp.asarray(pos), jnp.asarray(act),
                                      NULL_CTX)
        tc, tlg = tapi.decode_slotted(tparams, tc, torch.from_numpy(tok),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(act))
        assert_logits_close(tlg[:, 0].numpy(), np.asarray(jlg[:, 0]),
                            BF16_RTOL)
        tok = np.asarray(jlg[:, 0]).argmax(-1).astype(np.int32)
        pos = pos + 1
