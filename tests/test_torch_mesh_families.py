"""The recurrent and enc-dec families served on a mesh of gloo ranks
against the JAX package's single-device functions (``NULL_CTX``), the
same weights on both sides (the reference's parameters through
``repro_torch.interop``), reduced configs in float32:

- mamba2 (SSD heads over the model axis), recurrentgemma (RG-LRU
  channels over the model axis, the ring attention over the query heads
  of its one KV head, the ring's slots cut under +seqkv) and whisper
  (self- and cross-attention heads, ``gelu_mlp`` column- then
  row-parallel; positions and frames cut under +seqkv), on (1, 2) and
  (2, 2) ("data", "model") meshes under each executor: prefill, then
  teacher-forced decode steps; every step's logits within 1e-4 of
  max|logit| with the greedy tokens exact (the suite's f32 rule), and the
  SSD and RG-LRU states and conv windows gathered from the ranks within
  1e-4 of the reference's largest magnitude after prefill and at the end;
- mamba2's chunk lane (a partial last chunk) and a slotted step with one
  live row, on both meshes;
- each family through ``make_step``'s prefill (whisper's frames beside the
  tokens) and decode with their default int8 KV, against the port's
  one-device model of that config;
- mamba2 through ``ServingEngine`` on (1, 2): token streams, host syncs,
  step counts and program calls equal to the JAX engine's.

The ranks of each mesh start once (a module fixture: one launch of (2, 2)
and one of (1, 2)), each on one intra-op thread, while the reference runs
here.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import torch_mesh_family_ranks as ranks                      # noqa: E402
from repro.configs.registry import get_config as jget        # noqa: E402
from repro.models import NULL_CTX, build_model as jbuild     # noqa: E402
from repro.runtime.serving import Request as JRequest        # noqa: E402
from repro.runtime.serving import ServingEngine as JEngine   # noqa: E402
from repro_torch.launch.mesh import launch                   # noqa: E402

RTOL = 1e-4
MESHES = ((1, 2), (2, 2))


def jcfg(name):
    return jget(ranks.FAMILIES[name]).reduced().replace(dtype="float32")


def to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _state_np(name, c):
    if name == "mamba2":
        return np.asarray(c.h), np.asarray(c.conv)
    if name == "hybrid":
        return np.asarray(c["state"].h), np.asarray(c["state"].conv)
    return None


def ref_family(name, params, toks, frames):
    """The reference's prefill + teacher-forced decode (jitted): per-step
    logits (steps+1, B, V) and the state after prefill and at the end."""
    cfg = jcfg(name)
    api = jbuild(cfg)
    S = ranks.FAM_S[name]
    batch = {"tokens": jnp.asarray(toks[:, :S])}
    if name == "whisper":
        batch["frames"] = jnp.asarray(frames)
    prefill = jax.jit(lambda p, b: api.prefill(p, b, NULL_CTX))
    decode = jax.jit(lambda p, c, t: api.decode(p, c, t, NULL_CTX))
    c, lg = prefill(params, batch)
    logits, states = [np.asarray(lg[:, -1])], [_state_np(name, c)]
    for i in range(S, toks.shape[1]):
        c, lg = decode(params, c, jnp.asarray(toks[:, i]))
        logits.append(np.asarray(lg[:, -1]))
    states.append(_state_np(name, c))
    return np.stack(logits), states


def ref_chunk(params, prompt):
    """The reference's chunk lane into slot 1 and the slotted step."""
    api = jbuild(jcfg("mamba2"))
    state = api.init_caches(ranks.FAM_B, 64)
    chunks = []
    for start in range(0, ranks.CHUNK_PROMPT, ranks.CHUNK):
        valid = min(ranks.CHUNK, ranks.CHUNK_PROMPT - start)
        ch = np.zeros((1, ranks.CHUNK), np.int32)
        ch[0, :valid] = prompt[start:start + valid]
        i32 = [jnp.asarray(v, jnp.int32) for v in (1, start, valid)]
        state, lg = api.prefill_chunk(params, state, jnp.asarray(ch), *i32,
                                      NULL_CTX)
        chunks.append(np.asarray(lg[:, -1]))
    state, lg = api.decode_slotted(
        params, state, jnp.array([0, prompt[ranks.CHUNK_PROMPT]],
                                 jnp.int32),
        jnp.array([0, ranks.CHUNK_PROMPT], jnp.int32),
        jnp.array([False, True]), NULL_CTX)
    return chunks, np.asarray(lg[:, 0]), _state_np("mamba2", state)


def ref_engine(params, case):
    plan, kw = ranks.ENGINE_CASES[case]
    cfg = jcfg("mamba2")
    rng = np.random.default_rng(0)
    reqs = [JRequest(rid=i, prompt=rng.integers(0, cfg.vocab_size, p,
                                                dtype=np.int32),
                     max_new_tokens=n, arrival_step=a)
            for i, (n, a, p) in enumerate(plan)]
    eng = JEngine(jbuild(cfg), NULL_CTX, 2, 8, max_new_cap=32, **kw)
    st = eng.run(params, reqs, max_steps=400)
    keys = ("mode", "completed", "decode_steps", "macro_steps",
            "decode_tokens", "admissions", "prefill_chunks")
    return ([r.generated for r in reqs], eng.host_syncs,
            {k: st[k] for k in keys},
            {k: v["calls"] for k, v in st["runtime"].items()})


@pytest.fixture(scope="module")
def run():
    params, trees, toks = {}, {}, {}
    rng = np.random.default_rng(11)
    for i, name in enumerate(ranks.FAMILIES):
        cfg = jcfg(name)
        params[name] = jax.jit(jbuild(cfg).init)(jax.random.key(20 + i))
        trees[name] = to_numpy_tree(params[name])
        toks[name] = rng.integers(
            0, cfg.vocab_size, (ranks.FAM_B, ranks.FAM_S[name]
                                + ranks.FAM_STEPS)).astype(np.int32)
    wcfg = jcfg("whisper")
    frames = rng.standard_normal((ranks.FAM_B, wcfg.encoder.n_frames,
                                  wcfg.d_model)).astype(np.float32)
    handles = {shape: launch(ranks.families_rank, shape, ("data", "model"),
                             (trees, toks, frames, shape == (1, 2)),
                             timeout_s=300)
               for shape in MESHES}
    try:
        ref = {name: ref_family(name, params[name], toks[name], frames)
               for name in ranks.FAMILIES}
        ref["chunk"] = ref_chunk(params["mamba2"], toks["mamba2"][1])
        ref["engine"] = {case: ref_engine(params["mamba2"], case)
                         for case in ranks.ENGINE_CASES}
    finally:
        res = {shape: h.join() for shape, h in handles.items()}
    return ref, res


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= RTOL * max(np.abs(want).max(), 1e-6), (what, err)


def _logits_close(got, want, what):
    """Per step within RTOL of that step's max|logit|, tokens exact."""
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    for i, (g, w) in enumerate(zip(got, want)):
        err = np.abs(g - w).max()
        assert err <= RTOL * np.abs(w).max(), (what, i, err)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("executor", ranks.EXECUTORS)
@pytest.mark.parametrize("shape", MESHES, ids=("1x2", "2x2"))
@pytest.mark.parametrize("name", list(ranks.FAMILIES))
def test_family_on_mesh_matches_reference(run, name, shape, executor):
    ref, res = run
    want, want_states = ref[name]
    for r in res[shape]:
        out = r[(name, executor)]
        _logits_close(out["logits"].numpy(), want, (name, r["coords"]))
        for got, w in zip(out["states"], want_states):
            if w is None:
                assert got is None
                continue
            _close(got[0].numpy(), w[0], (name, "h"))
            _close(got[1].numpy(), w[1], (name, "conv"))
        assert out["bytes"] > 0


@pytest.mark.parametrize("executor", ranks.EXECUTORS[1:])
@pytest.mark.parametrize("shape", MESHES, ids=("1x2", "2x2"))
@pytest.mark.parametrize("name", list(ranks.FAMILIES))
def test_make_step_serves_the_family_with_int8_kv(run, name, shape,
                                                  executor):
    """``make_step``'s prefill (whisper's frames cut beside the tokens)
    and decode bundles, int8 KV by default as the reference's: the ring
    and the self cache quantized, cut by heads or (+seqkv) by slots and
    positions, equal to the port's one-device model of the same config
    within 1e-4 of max|logit| with the tokens exact."""
    _, res = run
    for r in res[shape]:
        rel, tokens_equal = r[("make_step", name, executor)]
        assert tokens_equal, (name, r["coords"])
        assert max(rel) <= RTOL, (name, r["coords"], rel)


@pytest.mark.parametrize("executor", ranks.EXECUTORS)
@pytest.mark.parametrize("shape", MESHES, ids=("1x2", "2x2"))
def test_mamba2_chunk_lane_and_slotted_step_on_mesh(run, shape, executor):
    ref, res = run
    chunks, step, state = ref["chunk"]
    owners = 0
    for r in res[shape]:
        out = r[("mamba2", executor)]["chunk"]
        if out["mine"]:
            owners += 1
            assert len(out["chunks"]) == len(chunks)
            for g, w in zip(out["chunks"], chunks):
                _logits_close(g.numpy()[None], w[None], "chunk")
        # the row with no live slot keeps its bytes; slot 1's logits match
        _logits_close(out["step"].numpy()[1:][None], step[1:][None], "step")
        _close(out["state"][0].numpy(), state[0], "h")
        _close(out["state"][1].numpy(), state[1], "conv")
    assert owners == 2          # the model ranks of slot 1's data row


@pytest.mark.parametrize("case", sorted(ranks.ENGINE_CASES))
def test_mamba2_engine_on_mesh_matches_reference_engine(run, case):
    ref, res = run
    want_streams, want_syncs, want_stats, want_calls = ref["engine"][case]
    for r in res[(1, 2)]:
        streams, syncs, stats, calls, mesh = r["engine"][case]
        assert streams == want_streams
        assert syncs == want_syncs
        assert stats == want_stats
        assert calls == want_calls
        assert mesh["bytes_total"] > 0 and mesh["control_calls"] > 0


def test_ssd_conv_window_layout_round_trips():
    """``ssd_state_local`` cuts a whole SSD state into a rank's layout
    (its heads' H; its heads' xs channels followed by the whole bc) and
    ``ssd_state_gather``'s layout puts it back: checked on a fake 2-wide
    model axis, rank by rank."""
    import types
    from repro_torch.kv.state import RecurrentState, ssd_state_local
    from repro_torch.models.sharding import ShardingCtx, sub_operator
    g = torch.Generator().manual_seed(0)
    d_in, gn = 8, 4
    whole = RecurrentState(h=torch.randn(3, 2, 4, 2, 2, generator=g),
                           conv=torch.randn(3, 2, 3, d_in + gn, generator=g))
    parts = []
    for m in range(2):
        mesh = types.SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 1, "model": 2},
            size=2, index=lambda axes, m=m: m if "model" in axes else 0)
        ctx = ShardingCtx(mesh, sub_operator())
        parts.append(ssd_state_local(whole, ctx, d_in, ("model",)))
    for m, p in enumerate(parts):
        assert torch.equal(p.h, whole.h[:, :, 2 * m:2 * m + 2])
        assert torch.equal(p.conv[..., :4],
                           whole.conv[..., 4 * m:4 * m + 4])
        assert torch.equal(p.conv[..., 4:], whole.conv[..., d_in:])
    xs = torch.cat([p.conv[..., :4] for p in parts], dim=-1)
    assert torch.equal(torch.cat([xs, parts[0].conv[..., 4:]], -1),
                       whole.conv)
