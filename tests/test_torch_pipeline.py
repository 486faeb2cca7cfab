"""Pipeline-parallel decode over the pod axis (``core/pipeline.py``)
against the reference's own ``make_pp_step``.

The reference runs in a subprocess on a (2, 1, 2) ("pod", "data", "model")
XLA host mesh of four devices, as ``tests/test_distributed.py`` runs it;
the port runs on four gloo ranks on the same mesh (started once, a module
fixture), every executor, the same staged parameters on both sides (the
reference's ``stage_params`` of its init, carried across by
``interop.stage_params_from_numpy``) and the same tokens: reduced
internlm2-1.8b at 4 layers (2 a stage), B=4, 4 calls, f32 and bf16.

- every stage's logits: f32 within 1e-4 of max|logit| while no stored int8
  K/V byte has flipped (each counted exactly against the reference's
  cache), 2e-2 after a flip, greedy tokens exact; bf16 within 3e-2 (bf16
  sums in other orders may pick another argmax at a near-tie: tokens are
  not compared); each stage's cursor (``lengths``) exact; ``x_carry``
  within the logits' tolerance of its largest magnitude;
- the pod axis carries exactly B_local * d_model / M * itemsize bytes a
  call a rank, at the one site ``pp_hop``, and nothing else;
- the port runs the sub-operator table under every executor (the bundle's
  name keeps ``operator_centric``), as the reference does;
- train, prefill and a non-transformer family raise as the reference's.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import torch_mesh_family_ranks as ranks                      # noqa: E402
from repro.configs.registry import get_config as jget        # noqa: E402
from repro.core.pipeline import stage_params as jstage       # noqa: E402
from repro.models import build_model as jbuild               # noqa: E402
from repro_torch.launch.mesh import launch                   # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ("float32", "bfloat16")
SEED = 0
F32_RTOL, FLIP_RTOL, BF16_RTOL = 1e-4, 2e-2, 3e-2

REF = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs.registry import get_config
    from repro.configs.shapes import ShapeConfig
    from repro.core.pipeline import make_pp_step, stage_params
    from repro.models import build_model

    inp = pickle.load(open(sys.argv[1], "rb"))
    mesh = Mesh(np.array(jax.devices()).reshape(2, 1, 2),
                ("pod", "data", "model"))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    out = {}
    for dtype in inp["dtypes"]:
        cfg = get_config(inp["arch"]).reduced().replace(
            n_layers=inp["layers"], dtype=dtype)
        shape = ShapeConfig("pp", seq_len=inp["S"], global_batch=inp["B"],
                            mode="decode")
        bundle = make_pp_step(cfg, shape, mesh, executor="sub_operator")
        compiled = bundle.lower().compile()
        api = build_model(cfg.replace(kv_dtype="int8"))
        staged = stage_params(api.init(jax.random.key(inp["seed"])), 2)
        params = jax.device_put(staged, bundle.in_shardings[0])
        caches = jax.tree.map(lambda s, sh: jax.device_put(
            jnp.zeros(s.shape, s.dtype), sh),
            bundle.abstract_args[1], bundle.in_shardings[1])
        calls = []
        with mesh:
            for toks in inp["toks"]:
                t = jax.device_put(jnp.asarray(toks),
                                   bundle.in_shardings[2])
                caches, logits = compiled(params, caches, t)
                calls.append({
                    "logits": f32(logits)[:, :, 0],
                    "lengths": np.asarray(caches["lengths"]),
                    "x_carry": f32(caches["x_carry"])[:, :, 0],
                    "k": np.asarray(caches["k"]),
                    "v": np.asarray(caches["v"]),
                    "k_scale": np.asarray(caches["k_scale"])})
        out[dtype] = {"calls": calls, "embed_sum": float(
            jnp.sum(staged["embed"]["table"].astype(jnp.float32)))}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def to_numpy_tree(tree):
    """JAX pytree -> nested dicts of numpy (bf16 as exact f32)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    a = jnp.asarray(tree)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    trees, sums = {}, {}
    for dtype in DTYPES:
        cfg = jget(ranks.PP_ARCH).reduced().replace(
            n_layers=ranks.PP_LAYERS, dtype=dtype, kv_dtype="int8")
        staged = jstage(jax.jit(jbuild(cfg).init)(jax.random.key(SEED)),
                        ranks.PP_STAGES)
        trees[dtype] = to_numpy_tree(staged)
        sums[dtype] = float(trees[dtype]["embed"]["table"].sum())
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 512, (ranks.PP_CALLS, ranks.PP_STAGES,
                                 ranks.PP_B)).astype(np.int64)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"dtypes": DTYPES, "arch": ranks.PP_ARCH,
                     "layers": ranks.PP_LAYERS, "S": ranks.PP_S,
                     "B": ranks.PP_B, "seed": SEED,
                     "toks": toks.astype(np.int32)}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REF, str(tmp / "in.pkl"),
                            str(tmp / "out.pkl")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    handle = launch(ranks.pp_rank, (2, 1, 2), ("pod", "data", "model"),
                    (trees, toks), timeout_s=300)
    try:
        _, err = ref.communicate(timeout=600)
        assert ref.returncode == 0, err[-3000:]
    finally:
        res = handle.join()
    with open(tmp / "out.pkl", "rb") as f:
        want = pickle.load(f)
    for dtype in DTYPES:
        np.testing.assert_allclose(want[dtype]["embed_sum"], sums[dtype],
                                   rtol=1e-6)
    return want, res


def _stage_ranks(res):
    """{stage: [the results of its ranks]}."""
    out = {}
    for r in res:
        out.setdefault(r["coords"]["pod"], []).append(r)
    return out


def _flips(got: torch.Tensor, want: np.ndarray, bf16: bool) -> int:
    """Stored int8 K/V bytes that differ from the reference's: in f32
    each by one step and rare; in bf16 (K/V rounded to bf16 before they
    are quantized, at other points on the two sides) a few steps and at
    most 1% of the bytes."""
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    if bf16:
        assert (d > 0).sum() <= 1e-2 * d.size, (d > 0).sum() / d.size
    else:
        assert d.max() <= 1
        assert (d > 0).sum() <= 1e-3 * d.size
    return int((d > 0).sum())


@pytest.mark.parametrize("executor", ranks.PP_EXECUTORS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pp_decode_matches_reference(run, dtype, executor):
    want, res = run
    calls = want[dtype]["calls"]
    for s, rs in _stage_ranks(res).items():
        flips = 0
        for r in rs:
            got = r[(dtype, executor)]["calls"]
            for t, (g, w) in enumerate(zip(got, calls)):
                bf16 = dtype == "bfloat16"
                flips += _flips(g["k"], w["k"][s], bf16) \
                    + _flips(g["v"], w["v"][s], bf16)
                wl = w["logits"][s]
                scale = np.abs(wl).max()
                err = np.abs(g["logits"].numpy() - wl).max()
                if dtype == "float32":
                    rtol = F32_RTOL if flips == 0 else FLIP_RTOL
                    np.testing.assert_array_equal(
                        g["logits"].numpy().argmax(-1), wl.argmax(-1))
                else:
                    rtol = BF16_RTOL
                assert err <= rtol * scale, (s, t, err, scale, flips)
                assert g["length"] == w["lengths"][s] == t + 1
                wx = w["x_carry"][s]
                xerr = np.abs(g["x_carry"][:, 0].numpy() - wx).max()
                assert xerr <= rtol * max(np.abs(wx).max(), 1e-6), (s, t,
                                                                   xerr)


def test_pp_stages_run_the_zero_carry_at_call_zero(run):
    """At call 0 the stage s > 0 runs on the all-zero initial x_carry
    (RMSNorm of a zero row is zero, not NaN): its cache holds finite
    scales and its logits are finite, as the reference's."""
    want, res = run
    for r in res:
        if r["coords"]["pod"] == 0:
            continue
        g = r[("float32", "sub_operator")]["calls"][0]
        assert torch.isfinite(g["logits"]).all()
        assert torch.isfinite(g["k_scale"]).all()
    assert np.isfinite(want["float32"]["calls"][0]["logits"]).all()


@pytest.mark.parametrize("executor", ranks.PP_EXECUTORS)
def test_pp_hop_carries_only_the_embeddings(run, executor):
    """One exchange a call a rank on the pod axis, exactly its
    (B_local, 1, d_model / M) slice of x_carry, and nothing else crosses
    pod (KV and weights never do)."""
    _, res = run
    cfg = ranks.pp_cfg("float32")
    for dtype in DTYPES:
        for r in res:
            out = r[(dtype, executor)]
            per_call = ranks.PP_B * cfg.d_model // 2 * out["itemsize"]
            for t, c in enumerate(out["calls"]):
                assert c["pod_bytes"] == {"pod|pp_hop": (t + 1) * per_call}


def test_pp_runs_the_sub_operator_table_under_every_executor(run):
    _, res = run
    for r in res:
        for ex in ranks.PP_EXECUTORS:
            out = r[("float32", ex)]
            assert out["name"].endswith(f"|{ex}|pp2|decode")
            want = "sub_operator+seqkv" if ex.endswith("+seqkv") \
                else "sub_operator"
            assert out["rules"] == want
        # operator_centric runs the very same program as sub_operator
        a = r[("float32", "operator_centric")]["calls"]
        b = r[("float32", "sub_operator")]["calls"]
        for x, y in zip(a, b):
            assert torch.equal(x["logits"], y["logits"])


def test_pp_refuses_what_the_reference_refuses():
    import types
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.execution import make_step
    mesh = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 shape={"pod": 2, "data": 1, "model": 2},
                                 devices_shape=(2, 1, 2), size=4,
                                 device=torch.device("cpu"))
    cfg = get_config("internlm2-1.8b").reduced()
    for mode in ("train", "prefill"):
        with pytest.raises(NotImplementedError, match="decode"):
            make_step(cfg, ShapeConfig("t", 8, 4, mode), mesh,
                      pod_strategy="pp")
    dec = ShapeConfig("t", 8, 4, "decode")
    with pytest.raises(NotImplementedError, match="transformer-family"):
        make_step(get_config("mamba2-1.3b").reduced(), dec, mesh,
                  pod_strategy="pp")
    with pytest.raises(ValueError, match="pipeline stages"):
        make_step(cfg, dec, mesh, pod_strategy="pp")        # 3 layers
    b = make_step(cfg.replace(n_layers=4, kv_dtype="bfloat16"), dec, mesh,
                  "operator_centric", pod_strategy="pp", kv_int8=False)
    assert b.name.endswith("|operator_centric|pp2|decode")
    assert b.ctx.rules.name == "sub_operator"
    assert b.ctx.rules.rules["batch"] == ("data",)
    # the pod axis joins the batch axes under dp, as before
    b = make_step(cfg, dec, mesh)
    assert b.ctx.rules.rules["batch"] == ("pod", "data")


def test_stage_params_cuts_the_reference_stages():
    """The port's ``stage_params`` of the whole tree equals, stage by
    stage, the reference's staged tree carried across by interop."""
    from repro_torch.core.pipeline import stage_params
    from repro_torch.interop import (params_from_numpy,
                                     stage_params_from_numpy)
    cfg = jget(ranks.PP_ARCH).reduced().replace(n_layers=4)
    params = jax.jit(jbuild(cfg).init)(jax.random.key(3))
    tree = to_numpy_tree(params)
    staged = to_numpy_tree(jstage(params, 2))
    tcfg = ranks.pp_cfg("float32").replace(kv_dtype="bfloat16")
    whole = stage_params(params_from_numpy(tree, tcfg, "cpu"), 2)
    assert len(whole["blocks"]) == 2
    for s in range(2):
        mine = stage_params_from_numpy(staged, tcfg, s, "cpu")
        assert len(mine["blocks"]) == 2
        for a, b in zip(mine["blocks"], whole["blocks"][s]):
            assert torch.equal(a["attn"]["wq"]["w"], b["attn"]["wq"]["w"])
            assert torch.equal(a["ffn"]["w_down"]["w"],
                               b["ffn"]["w_down"]["w"])
        assert torch.equal(mine["embed"]["table"], whole["embed"]["table"])
    with pytest.raises(ValueError, match="pipeline stages"):
        stage_params(params_from_numpy(tree, tcfg, "cpu"), 3)
