"""Drain mode of the port against the JAX reference, in float32.

- ``decode_step`` (one shared cursor at ``cache.length``, the whole extent
  read with ``kv_limit = length + 1``) against the JAX ``decode_step`` for
  dense and int8 KV: logits within 1e-4 of max|logit| (2e-2 once an int8
  rounding flip has been counted, as in ``test_torch_model.py``), tokens
  exact;
- ``decode_step`` equals ``decode_step_slotted`` under a uniform cursor,
  bit for bit;
- the drain engine's token streams, admit steps, host syncs and program
  calls equal the JAX drain engine's; continuous mode admits a late
  request earlier than drain; ``mode="auto"`` resolves to continuous;
  drain refuses the chunk lane; the CLI serves ``--mode drain`` and
  ``--a-shards 2``.
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
from repro_torch.kv.cache import KVCache                     # noqa: E402
from repro_torch.launch import serve as serve_cli            # noqa: E402
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.runtime.serving import Request, ServingEngine  # noqa: E402

torch.set_num_threads(2)

PROMPT_LEN = 8
PLAN = [(9, 0), (13, 0), (5, 2), (9, 6)]
LOGIT_RTOL = 1e-4
INT8_FLIP_RTOL = 2e-2


def to_numpy_tree(tree):
    if isinstance(tree, JaxQT):
        return {"values": np.asarray(tree.values),
                "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(jnp.asarray(tree))


@pytest.fixture(scope="module", params=["dense", "int8kv"])
def models(request):
    over = {"kv_dtype": "int8"} if request.param == "int8kv" else {}
    jcfg = ASSIGNED["qwen2-0.5b"].reduced().replace(dtype="float32", **over)
    tcfg = get_config("qwen2-0.5b").reduced().replace(dtype="float32",
                                                      **over)
    japi = jax_build_model(jcfg)
    jparams = japi.init(jax.random.key(0))
    tapi = build_model(tcfg, device="cpu")
    tparams = params_from_numpy(to_numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, japi, jparams, tapi, tparams


def int8_flips(jc, tc) -> int:
    """Stored int8 K/V bytes that differ (0 for a float cache): XLA and
    PyTorch sum in different orders, so a value a last bit apart can round
    to the neighbouring int8 step. Each flip is one step and they are
    rare."""
    if jc.k_scale is None:
        return 0
    n = 0
    for j, t in ((jc.k, tc.k), (jc.v, tc.v)):
        d = np.abs(t.numpy().astype(np.int32) - np.asarray(j).astype(np.int32))
        assert d.max() <= 1
        n += int((d > 0).sum())
    assert n <= 1e-3 * 2 * tc.k.numel(), n
    return n


def assert_logits_close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _prompts(vocab, n=2, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, PROMPT_LEN),
                                                dtype=np.int32)


def test_decode_step_matches_reference(models):
    """Batch prefill, then six shared-cursor steps on both sides."""
    jcfg, japi, jparams, tapi, tparams = models
    prompts = _prompts(jcfg.vocab_size)
    jc, jlg = japi.prefill(jparams, {"tokens": jnp.asarray(prompts)},
                           NULL_CTX)
    tc, tlg = tapi.prefill(tparams, torch.from_numpy(prompts))
    flips = int8_flips(jc, tc)
    assert_logits_close(tlg[:, -1].numpy(), np.asarray(jlg[:, -1]),
                        INT8_FLIP_RTOL if flips else LOGIT_RTOL)
    tok = np.asarray(jlg[:, -1]).argmax(-1).astype(np.int32)
    jstep = jax.jit(lambda p, c, t: japi.decode(p, c, t, NULL_CTX))
    for _ in range(6):
        jc, jlg = jstep(jparams, jc, jnp.asarray(tok))
        tc, tlg = tapi.decode(tparams, tc, torch.from_numpy(tok))
        flips = int8_flips(jc, tc)
        jlg, tlg = np.asarray(jlg[:, 0]), tlg[:, 0].numpy()
        assert_logits_close(tlg, jlg, INT8_FLIP_RTOL if flips else LOGIT_RTOL)
        np.testing.assert_array_equal(tlg.argmax(-1), jlg.argmax(-1))
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc.length))
        tok = jlg.argmax(-1).astype(np.int32)
    if jc.k_scale is None:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k),
                                   rtol=1e-4, atol=1e-5)


def test_decode_step_equals_slotted_under_uniform_cursor(models):
    """Every row at one cursor and active: the drain entry and the slotted
    step give the same logits and cache bytes."""
    _, _, _, tapi, tparams = models
    prompts = torch.from_numpy(_prompts(tapi.config.vocab_size, seed=1))
    cache, lg = tapi.prefill(tparams, prompts)
    twin = KVCache(*(None if t is None else t.clone()
                     for t in (cache.k, cache.v, cache.k_scale,
                               cache.v_scale, cache.length)))
    tok = lg[:, -1].argmax(-1).to(torch.int32)
    tok2 = tok.clone()
    pos = torch.full((2,), PROMPT_LEN, dtype=torch.int32)
    act = torch.ones(2, dtype=torch.bool)
    for _ in range(4):
        cache, la = tapi.decode(tparams, cache, tok)
        twin, lb = tapi.decode_slotted(tparams, twin, tok2, pos, act)
        assert torch.equal(la, lb)
        tok = tok2 = la[:, 0].argmax(-1).to(torch.int32)
        pos = pos + 1
    assert torch.equal(cache.length, twin.length)
    for a, b in ((cache.k, twin.k), (cache.v, twin.v),
                 (cache.k_scale, twin.k_scale)):
        assert (a is None and b is None) or torch.equal(a, b)


def _requests(cls, vocab, plan, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, PROMPT_LEN,
                                           dtype=np.int32),
                max_new_tokens=new, arrival_step=arr)
            for i, (new, arr) in enumerate(plan)]


def test_drain_engine_matches_reference(models):
    jcfg, japi, jparams, tapi, tparams = models
    jreqs = _requests(JaxRequest, jcfg.vocab_size, PLAN)
    jeng = JaxEngine(japi, NULL_CTX, 2, PROMPT_LEN, mode="drain",
                     max_new_cap=32)
    jstats = jeng.run(jparams, jreqs, max_steps=400)
    treqs = _requests(Request, jcfg.vocab_size, PLAN)
    teng = ServingEngine(tapi, 2, PROMPT_LEN, device="cpu", mode="drain",
                         max_new_cap=32)
    tstats = teng.run(tparams, treqs, max_steps=400)
    assert tstats["mode"] == jstats["mode"] == "drain"
    assert tstats["completed"] == jstats["completed"] == len(PLAN)
    for a, b in zip(jreqs, treqs):
        assert b.generated == a.generated, a.rid
        assert b.admit_step == a.admit_step, a.rid
    assert teng.host_syncs == jeng.host_syncs
    for key in ("decode_steps", "macro_steps", "decode_tokens",
                "admissions", "overlapped_admissions"):
        assert tstats[key] == jstats[key], key
    jrt, trt = jstats["runtime"], tstats["runtime"]
    assert set(trt) == set(jrt) == {"serve_prefill_batch",
                                    "serve_decode_drain"}
    for name in trt:
        assert trt[name]["calls"] == jrt[name]["calls"], name


def test_continuous_admits_late_arrivals_before_drain(models):
    """rid2 waits for BOTH initial requests under drain; continuous gives
    it rid0's slot as soon as that frees. Both modes produce the same
    greedy tokens for the same prompts."""
    jcfg, _, _, tapi, tparams = models
    plan = [(2, 0), (14, 0), (2, 3)]
    cont = _requests(Request, jcfg.vocab_size, plan)
    drain = _requests(Request, jcfg.vocab_size, plan)
    s_cont = ServingEngine(tapi, 2, PROMPT_LEN, device="cpu",
                           mode="continuous").run(tparams, cont,
                                                  max_steps=300)
    s_drain = ServingEngine(tapi, 2, PROMPT_LEN, device="cpu",
                            mode="drain").run(tparams, drain, max_steps=300)
    assert s_cont["completed"] == s_drain["completed"] == 3
    assert cont[2].admit_step < drain[2].admit_step
    assert drain[2].admit_step >= drain[1].max_new_tokens - 1
    for a, b in zip(cont, drain):
        assert a.generated == b.generated


def test_mode_resolution_and_validation():
    api = build_model(get_config("qwen2-0.5b").reduced(), device="cpu")
    eng = ServingEngine(api, 2, PROMPT_LEN, device="cpu", mode="auto")
    assert eng.mode == "continuous"
    assert ServingEngine(api, 2, PROMPT_LEN, device="cpu",
                         mode="drain").mode == "drain"
    with pytest.raises(ValueError, match="chunked prefill requires"):
        ServingEngine(api, 2, PROMPT_LEN, device="cpu", mode="drain",
                      prefill_chunk=4)
    with pytest.raises(ValueError, match="bogus"):
        ServingEngine(api, 2, PROMPT_LEN, device="cpu", mode="bogus")
    # a drain engine takes no prompt longer than its static width
    with pytest.raises(ValueError, match="prompt length"):
        ServingEngine(api, 2, PROMPT_LEN, device="cpu", mode="drain").submit(
            Request(rid=0, prompt=np.ones(PROMPT_LEN + 1, np.int32),
                    max_new_tokens=2))


@pytest.mark.parametrize("extra,program", [
    (["--mode", "drain"], "serve_decode_drain"),
    (["--a-shards", "2", "--block-size", "2", "--kv-bucket-chunk", "8",
      "--prefill-chunk", "4"], "serve_decode_block_s8"),
])
def test_cli_serves_drain_and_split_on_cpu(capsys, extra, program):
    serve_cli.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                    "--prompt-len", "6", "--max-new", "4",
                    "--arrival-every", "2"] + extra)
    out = capsys.readouterr().out
    assert "'completed': 3" in out and program in out
