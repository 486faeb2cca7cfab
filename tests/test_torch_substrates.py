"""The training substrates of the port against the JAX reference, on the
CPU: AdamW and its schedule, the synthetic data pipeline, the checkpointer
(the reference's on-disk format, both ways), the elastic controller and
the train driver.

- ``adamw_update`` (clipping on and off, bf16 and f32 leaves, a state at
  step 5), ``cosine_lr`` (steps 0-120) and ``global_norm`` against the
  reference leaf by leaf: within 2e-6 of each leaf's largest magnitude
  (the global norm's sum runs in another order);
- ``batch_at`` gives the reference's bytes for every family; the prefetch
  thread starts in ``start`` and ``stop`` joins it;
- a checkpoint written by the port restores in the reference's
  ``restore_pytree`` and the other way round (a nested dict with a bf16
  leaf), bit for bit; a shape or dtype that differs from the template
  raises;
- the port versions of ``test_substrates.py``'s optimizer, data,
  checkpoint and elastic tests and of ``test_system.py``'s resume and
  loss-falls tests;
- a job that fails after step 7 (checkpoints every 5), recovers through
  the elastic controller and the checkpointer and is started again ends
  with an uninterrupted run's parameters and optimizer state, bit for
  bit; a checkpoint restored into a fresh model and optimizer equals the
  saved state bit for bit; one step registry serves calls of two
  families.

Every file goes under ``tmp_path``; the port runs on one intra-op thread
while this module runs (restored after).
"""
import os
import threading

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import ml_dtypes                                             # noqa: E402
import numpy as np                                           # noqa: E402

from repro.checkpoint import checkpointer as jckpt           # noqa: E402
from repro.configs.registry import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.data.synthetic import SyntheticLMData as JaxData  # noqa: E402
from repro.optim import adamw as jadamw                      # noqa: E402
from repro_torch.checkpoint.checkpointer import (Checkpointer,  # noqa: E402
                                                 latest_step,
                                                 restore_pytree,
                                                 save_pytree)
from repro_torch.configs.registry import REGISTRY, get_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMData       # noqa: E402
from repro_torch.interop import (adamw_state_from_numpy,     # noqa: E402
                                 tree_to_numpy)
from repro_torch.launch.train import train                   # noqa: E402
from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: E402
                                     adamw_update, cosine_lr,
                                     global_norm)
from repro_torch.runtime.elastic import ElasticController    # noqa: E402
from repro_torch.runtime.static_runtime import StaticRuntime  # noqa: E402
from repro_torch.tree import tree_leaves                     # noqa: E402

OPT_RTOL = 2e-6
ARCHS = ("qwen2-0.5b", "qwen3-moe-235b-a22b", "mamba2-1.3b",
         "recurrentgemma-9b", "internvl2-76b", "whisper-medium")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port while this module runs; restored
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=OPT_RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def _equal_trees(a, b):
    """Two torch trees of one structure, bit for bit (dtype included)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# optimizer against the reference
# ---------------------------------------------------------------------------

def _opt_case(seed, grad_scale):
    """A nested tree (a layer list on the port's side, stacked on the
    reference's), one bf16 leaf, a state at step 5."""
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"blocks": {"w": arr(2, 6, 5), "b": arr(2, 5)}, "emb": arr(7, 5)}
    g = {"blocks": {"w": arr(2, 6, 5, scale=grad_scale),
                    "b": arr(2, 5, scale=grad_scale)},
         "emb": arr(7, 5, scale=grad_scale)}
    mu = {"blocks": {"w": arr(2, 6, 5, scale=0.1), "b": arr(2, 5, scale=0.1)},
          "emb": arr(7, 5, scale=0.1)}
    nu = {k: ({kk: np.abs(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else np.abs(v))
          for k, v in mu.items()}
    return p, g, {"step": np.int32(5), "mu": mu, "nu": nu}


def _port_tree(p, bf16_emb=False):
    out = {"blocks": [{k: torch.from_numpy(v[i].copy())
                       for k, v in p["blocks"].items()} for i in range(2)],
           "emb": torch.from_numpy(p["emb"].copy())}
    if bf16_emb:
        out["emb"] = out["emb"].to(torch.bfloat16)
    return out


def _jax_tree(p, bf16_emb=False):
    out = jax.tree.map(jnp.asarray, p)
    if bf16_emb:
        out["emb"] = out["emb"].astype(jnp.bfloat16)
    return out


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])      # clip off / on
def test_adamw_update_matches_reference_leaf_by_leaf(grad_scale):
    p, g, st = _opt_case(0, grad_scale)
    jp, jg = _jax_tree(p, bf16_emb=True), _jax_tree(g)
    jst = jadamw.AdamWState(jnp.int32(5), _jax_tree(st["mu"]),
                            _jax_tree(st["nu"]))
    lr = 3e-4
    jnew, jstate, jinfo = jadamw.adamw_update(jp, jg, jst, lr=lr)
    tst = adamw_state_from_numpy(st, device="cpu")
    tnew, tstate, tinfo = adamw_update(_port_tree(p, bf16_emb=True),
                                       _port_tree(g), tst, lr=lr)
    assert tnew["emb"].dtype == torch.bfloat16
    _close(float(tinfo["grad_norm"]), float(jinfo["grad_norm"]))
    assert (float(jinfo["grad_norm"]) > 1.0) == (grad_scale > 1)
    assert int(tstate.step) == int(jstate.step) == 6
    got = tree_to_numpy(tnew)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jnew)
    for k in ("w", "b"):
        _close(got["blocks"][k], want["blocks"][k])
    # bf16: equal after rounding, or one ulp apart where the f32 value
    # sits on a rounding boundary
    d = np.abs(got["emb"] - want["emb"])
    assert (d <= np.abs(want["emb"]) * 2 ** -7).all()
    for name in ("mu", "nu"):
        gt = tree_to_numpy(getattr(tstate, name))
        wt = getattr(jstate, name)
        for k in ("w", "b"):
            _close(gt["blocks"][k], wt["blocks"][k])
        _close(gt["emb"], wt["emb"])


def test_cosine_lr_and_global_norm_match_reference():
    for s in range(0, 121, 3):
        want = float(jadamw.cosine_lr(jnp.int32(s), 3e-4, warmup=20,
                                      total=100))
        got = float(cosine_lr(torch.tensor(s, dtype=torch.int32), 3e-4,
                              warmup=20, total=100))
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, (s, got, want)
    p, g, _ = _opt_case(1, 1.0)
    _close(float(global_norm(_port_tree(g))),
           float(jadamw.global_norm(_jax_tree(g))))


# ---------------------------------------------------------------------------
# the port versions of test_substrates.py's optimizer tests
# ---------------------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    opt = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(params, grads, opt, lr=0.05,
                                      weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    grads = {"w": torch.full((4,), 1e6)}
    new, _, info = adamw_update(params, grads, opt, lr=1.0, clip_norm=1.0)
    assert float(info["grad_norm"]) > 1e5      # raw norm reported
    assert float(new["w"].abs().max()) <= 1.0 + 1e-6


def test_cosine_lr_shape():
    lrs = [float(cosine_lr(torch.tensor(s, dtype=torch.int32), 1.0,
                           warmup=10, total=100))
           for s in range(0, 100, 10)]
    assert lrs[0] < lrs[1]                      # warmup rises
    assert lrs[-1] < lrs[2]                     # decays later


def test_adamw_state_layout_and_roundtrip():
    """adamw_init gives f32 zero moments in the params' layout at step 0;
    the reference's state survives the numpy round trip exactly."""
    params = _port_tree(_opt_case(2, 1.0)[0], bf16_emb=True)
    opt = adamw_init(params)
    assert isinstance(opt, AdamWState) and int(opt.step) == 0
    assert all(t.dtype == torch.float32 and not t.any()
               for t in tree_leaves(opt.mu) + tree_leaves(opt.nu))
    _, _, st = _opt_case(3, 1.0)
    back = tree_to_numpy(adamw_state_from_numpy(st, device="cpu"))
    assert int(back["step"]) == 5
    np.testing.assert_array_equal(back["mu"]["blocks"]["w"],
                                  st["mu"]["blocks"]["w"])


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_batch_at_gives_reference_bytes(arch):
    jd = JaxData(JAX_REGISTRY[arch].reduced(), batch=3, seq=20, seed=9)
    td = SyntheticLMData(get_config(arch).reduced(), batch=3, seq=20,
                         seed=9)
    for step in (0, 5):
        want, got = jd.batch_at(step), td.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (arch, k)


def test_data_deterministic_across_restart():
    cfg = get_config("qwen2-0.5b").reduced()
    d1 = SyntheticLMData(cfg, batch=2, seq=16, seed=7)
    d2 = SyntheticLMData(cfg, batch=2, seq=16, seed=7)
    b_a, b_b = d1.batch_at(13), d2.batch_at(13)
    for k in b_a:
        np.testing.assert_array_equal(b_a[k], b_b[k])
    assert not np.array_equal(d1.batch_at(14)["tokens"], b_a["tokens"])


def test_data_is_learnable_structure():
    cfg = get_config("qwen2-0.5b").reduced()
    d = SyntheticLMData(cfg, batch=4, seq=64, seed=0, noise=0.0)
    b = d.batch_at(0)
    a = 31337 % cfg.vocab_size or 1
    bb = 917 % cfg.vocab_size
    pred = (b["tokens"].astype(np.int64) * a + bb) % cfg.vocab_size
    np.testing.assert_array_equal(pred, b["labels"])   # noiseless -> exact


def test_prefetch_thread_starts_in_start_and_stop_joins_it():
    cfg = get_config("qwen2-0.5b").reduced()
    before = threading.active_count()
    d = SyntheticLMData(cfg, batch=2, seq=8, seed=1, prefetch=2)
    assert threading.active_count() == before          # nothing at init
    it = iter(d.start(from_step=4))
    got = [next(it) for _ in range(3)]
    assert [s for s, _ in got] == [4, 5, 6]
    np.testing.assert_array_equal(got[1][1]["tokens"],
                                  d.batch_at(5)["tokens"])
    thread = d._thread
    d.stop()
    assert not thread.is_alive() and d._thread is None
    assert threading.active_count() == before


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "layers": [{"w": torch.full((2,), 3.0)},
                       {"w": torch.full((2,), 4.0)}]}
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (5, 10, 15):
        ck.save(s, **tree)
    assert latest_step(str(tmp_path)) == 15
    assert not os.path.exists(tmp_path / "step_00000005")   # GC'd
    step, restored = ck.restore(dict(tree))
    assert step == 15
    _equal_trees(restored, tree)


def test_checkpoint_shape_or_dtype_mismatch_raises(tmp_path):
    save_pytree({"w": torch.zeros((2, 2))}, str(tmp_path), 1)
    with pytest.raises(ValueError, match="shape"):
        restore_pytree({"w": torch.zeros((3, 3))}, str(tmp_path), 1)
    with pytest.raises(ValueError, match="dtype"):
        restore_pytree({"w": torch.zeros((2, 2), dtype=torch.bfloat16)},
                       str(tmp_path), 1)
    with pytest.raises(KeyError):
        restore_pytree({"v": torch.zeros((2, 2))}, str(tmp_path), 1)


def test_checkpoint_atomicity_no_done_marker_ignored(tmp_path):
    p = save_pytree({"w": torch.zeros(2)}, str(tmp_path), 1)
    os.remove(os.path.join(p, "DONE"))
    assert latest_step(str(tmp_path)) is None   # incomplete ckpt invisible


def _mixed_tree(seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    c = rng.standard_normal(5).astype(np.float32)
    return w, c


def test_port_checkpoint_restores_in_reference(tmp_path):
    w, c = _mixed_tree(0)
    save_pytree({"a": torch.from_numpy(w),
                 "b": {"c": torch.from_numpy(c).to(torch.bfloat16),
                       "n": torch.tensor(7, dtype=torch.int32)}},
                str(tmp_path), 3)
    template = {"a": jnp.zeros((3, 4)),
                "b": {"c": jnp.zeros(5, jnp.bfloat16),
                      "n": jnp.zeros((), jnp.int32)}}
    assert jckpt.latest_step(str(tmp_path)) == 3
    got = jckpt.restore_pytree(template, str(tmp_path), 3)
    np.testing.assert_array_equal(np.asarray(got["a"]), w)
    assert got["b"]["c"].dtype == jnp.bfloat16
    assert np.asarray(got["b"]["c"]).tobytes() == \
        c.astype(ml_dtypes.bfloat16).tobytes()
    assert int(got["b"]["n"]) == 7


def test_reference_checkpoint_restores_in_port(tmp_path):
    w, c = _mixed_tree(1)
    jckpt.save_pytree({"a": jnp.asarray(w),
                       "b": {"c": jnp.asarray(c).astype(jnp.bfloat16),
                             "n": jnp.int32(9)}}, str(tmp_path), 4)
    template = {"a": torch.zeros((3, 4)),
                "b": {"c": torch.zeros(5, dtype=torch.bfloat16),
                      "n": torch.zeros((), dtype=torch.int32)}}
    assert latest_step(str(tmp_path)) == 4
    got = restore_pytree(template, str(tmp_path), 4)
    np.testing.assert_array_equal(got["a"].numpy(), w)
    assert got["b"]["c"].dtype == torch.bfloat16
    assert got["b"]["c"].view(torch.int16).numpy().tobytes() == \
        c.astype(ml_dtypes.bfloat16).tobytes()
    assert int(got["b"]["n"]) == 9


# ---------------------------------------------------------------------------
# elastic controller
# ---------------------------------------------------------------------------

def test_elastic_failure_and_remesh():
    ec = ElasticController(n_data=16, n_model=16)
    assert ec.mesh_shape() == (16, 16)
    ec.inject_failure(3)
    d, m = ec.mesh_shape()
    assert d < 16 and 16 % d == 0 and m == 16
    assert any("FAIL" in e for e in ec.events)


def test_elastic_straggler_eviction():
    ec = ElasticController(n_data=8, n_model=4, patience=2)
    ec.observe_step(1.0)
    evicted = None
    for _ in range(5):
        evicted = ec.observe_step(10.0, slow_domain=5) or evicted
    assert evicted == 5
    assert 5 in ec.failed_domains


def test_elastic_recover_loop_resumes():
    ec = ElasticController(n_data=4, n_model=2)
    ec.inject_failure(0)
    calls = {}

    def make_mesh(shape):
        calls["mesh"] = shape
        return f"mesh{shape}"

    def recompile(mesh):
        calls["compiled_on"] = mesh
        return "exe"

    def restore(mesh):
        calls["restored_on"] = mesh
        return 42, {"params": "state"}

    mesh, step, state, exe = ec.recover(make_mesh, recompile, restore)
    assert step == 42 and exe == "exe"
    assert calls["mesh"][0] in (1, 2)          # data axis shrank to a divisor
    assert any("RESUME" in e for e in ec.events)


# ---------------------------------------------------------------------------
# the train driver (test_system.py's resume and loss-falls tests, the
# restored state, the elastic recovery)
# ---------------------------------------------------------------------------

def test_train_driver_checkpoint_resume(tmp_path):
    """Train, checkpoint, 'crash', resume: the restarted job continues from
    the saved step; the step is registered once and counted per call."""
    ck = str(tmp_path / "ckpt")
    rt = StaticRuntime()
    train("qwen2-0.5b", steps=12, batch=4, seq=64, reduced=True,
          ckpt_dir=ck, ckpt_every=6, log_every=6, device="cpu", runtime=rt)
    assert latest_step(ck) == 12
    assert rt.stats()["train"] == {"compiles": 1, "compile_s": 0.0,
                                   "calls": 12}
    _, opt, _ = train("qwen2-0.5b", steps=16, batch=4, seq=64,
                      reduced=True, ckpt_dir=ck, ckpt_every=100,
                      log_every=4, device="cpu", runtime=rt)
    assert int(opt.step) == 16
    assert rt.stats()["train"]["calls"] == 16


def test_training_reduces_loss():
    _, _, losses = train("internlm2-1.8b", steps=60, batch=8, seq=64,
                         reduced=True, log_every=10, device="cpu")
    first, last = losses[0][1], losses[-1][1]
    assert last < first, (first, last)


def test_restored_state_equals_saved_state_bit_for_bit(tmp_path):
    ck = str(tmp_path / "ckpt")
    params, opt, _ = train("qwen2-0.5b", steps=3, batch=2, seq=16,
                           ckpt_dir=ck, ckpt_every=3, device="cpu")
    from repro_torch.models.registry import build_model
    api = build_model(get_config("qwen2-0.5b").reduced(), device="cpu")
    fresh = api.init(1)
    step, state = Checkpointer(ck).restore(
        {"params": fresh, "opt": adamw_init(fresh)})
    assert step == 3 and int(state["opt"].step) == 3
    _equal_trees(state["params"], params)
    _equal_trees(state["opt"], opt)


def test_elastic_recovery_replays_to_the_uninterrupted_run(tmp_path):
    """A job that fails after step 7 (a node failure raised at the next
    dispatch; checkpoints every 5): the controller excludes the failed
    domain, re-meshes, looks the step up again and restores step 5 from
    the checkpointer into a fresh model; the job started again on the
    same directory replays steps 6-10 from the data pipeline and ends with
    an uninterrupted run's parameters and optimizer state, bit for bit."""
    from repro_torch.launch.train import train_step
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.elastic import NodeFailure
    kw = dict(steps=10, batch=2, seq=16, device="cpu", log_every=1)
    p_ref, o_ref, _ = train("qwen2-0.5b", **kw)
    ck = str(tmp_path / "ck")
    rt = StaticRuntime()

    def fail_after_step_7(name):
        if rt.stats()[name]["calls"] == 7:
            raise NodeFailure(0)
    rt.set_interceptor(fail_after_step_7)
    with pytest.raises(NodeFailure):
        train("qwen2-0.5b", ckpt_dir=ck, ckpt_every=5, runtime=rt, **kw)
    rt.set_interceptor(None)
    assert latest_step(ck) == 5
    ec = ElasticController(n_data=2, n_model=1)
    ec.inject_failure(0)
    api = build_model(get_config("qwen2-0.5b").reduced(), device="cpu")

    def restore(mesh):
        fresh = api.init(1)
        return Checkpointer(ck).restore(
            {"params": fresh, "opt": adamw_init(fresh)})
    mesh, step, state, step_fn = ec.recover(
        make_mesh=lambda shape: shape,
        recompile=lambda mesh: rt.compile_step("train", train_step),
        restore=restore)
    assert mesh == (1, 1) and step == 5 and int(state["opt"].step) == 5
    assert step_fn.calls == 7
    assert ec.failed_domains == [0] and "RESUME step=5" in ec.events
    p, o, losses = train("qwen2-0.5b", ckpt_dir=ck, ckpt_every=5,
                         runtime=rt, **kw)
    assert [s for s, _ in losses] == list(range(6, 11))
    assert rt.stats()["train"]["calls"] == 12
    _equal_trees(p, p_ref)
    _equal_trees(o, o_ref)


def test_train_runtime_serves_calls_of_another_config():
    """One runtime registers ``train`` once and serves a later call of
    another family with that call's loss: the same result as a fresh
    runtime's, bit for bit."""
    kw = dict(steps=2, batch=2, seq=16, device="cpu")
    rt = StaticRuntime()
    train("mamba2-1.3b", runtime=rt, **kw)
    p, o, _ = train("qwen2-0.5b", runtime=rt, **kw)
    p_ref, o_ref, _ = train("qwen2-0.5b", **kw)
    assert rt.stats()["train"]["calls"] == 4
    _equal_trees(p, p_ref)
    _equal_trees(o, o_ref)


def test_registry_is_left_as_found():
    """Nothing in this module's runs registers a config."""
    assert "dense-100m" not in REGISTRY
