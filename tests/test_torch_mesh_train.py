"""Training on a mesh of gloo ranks against the JAX reference's
single-device step, the same weights on both sides (the reference's
parameters through ``repro_torch.interop``), reduced configs in float32,
a global batch of 4 x 16 tokens from the reference's seeded synthetic
data:

- ``make_step(mode="train")`` (the executor's rules under fsdp) of
  reduced internlm2-1.8b on a (2, 2) ("data", "model") mesh under each
  executor, and on a (2, 1, 2) ("pod", "data", "model") mesh, where
  ``grad_sync`` sums over the pod axis hierarchically; tied qwen2-0.5b,
  phi3.5-moe (the aux loss in the loss) and internvl2 (the text-only
  loss) under sub_operator on (2, 2). Against ``jax.value_and_grad`` of
  the reference's ``build_model(cfg).loss`` and ``adamw_update`` at the
  same ``cosine_lr(step, 3e-4, warmup=100, total=10_000)``:
  - the loss and the grad norm within 1e-5, relative;
  - every leaf's gradient, gathered whole, within 1e-4 of the leaf's
    max |g| plus 1e-6 of the tree's largest gradient (the key biases'
    true gradient is 0: both sides hold rounding noise there);
  - every leaf's update over 3 steps within 1e-3 of the leaf's max
    |update|, plus one f32 ulp of the leaf's largest value a step (the
    warmup's first learning rates are 0, 3e-6 and 6e-6, so an update
    of ~1e-5 lands on the parameter's f32 grid: 3e-8 at |p| ~ 0.5); a
    value whose gradient is rounding noise (under the floor of 1e-6 of
    the tree's largest gradient, or where the two sides' gradients differ
    by more than 1e-4 of its own size: the key biases hold many), which
    Adam's normalised step magnifies to its full size, is held to
    |update| <= lr_t a step;
- operator_centric moves at least sub_operator's collective bytes;
- ``make_step(pod_strategy="pp")`` in training raises, and
  ``train(mesh=...)`` of mamba2 on the (2, 1, 2) ranks gives a finite
  loss.

Each mesh's ranks start once (a module fixture), one intra-op thread
each, while the reference runs here.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import torch_mesh_train_ranks as ranks                       # noqa: E402
from repro.configs.registry import get_config as jget        # noqa: E402
from repro.data.synthetic import SyntheticLMData as JaxData  # noqa: E402
from repro.models import NULL_CTX, build_model as jbuild     # noqa: E402
from repro.optim import adamw as jadamw                      # noqa: E402
from repro_torch.launch.mesh import launch                   # noqa: E402
from test_torch_mesh import to_numpy_tree                    # noqa: E402
from test_torch_train import assert_trees_close, flat_numpy  # noqa: E402

EXECUTORS = ("operator_centric", "sub_operator", "sub_operator+seqkv")
ARCHS = (ranks.DENSE, ranks.TIED, ranks.MOE, ranks.VLM)
STEPS = 3
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6
UPDATE_RTOL = 1e-3


def jcfg(arch):
    return jget(arch).reduced().replace(dtype="float32")


def inputs(arch, seed):
    """The reference's weights (JAX and numpy) and its batches (numpy)."""
    cfg = jcfg(arch)
    params = jax.jit(jbuild(cfg).init)(jax.random.key(seed))
    data = JaxData(cfg, ranks.B, ranks.S, seed=3)
    return params, to_numpy_tree(params), [data.batch_at(i)
                                           for i in range(STEPS)]


def reference(arch, params, batches, cfg=None):
    """The reference's single-device steps of ``cfg`` (``jcfg(arch)`` by
    default): the first batch's gradients, then per step (loss,
    grad_norm, parameters, lr_t)."""
    api = jbuild(cfg if cfg is not None else jcfg(arch))
    vg = jax.jit(jax.value_and_grad(lambda p, b: api.loss(p, b, NULL_CTX)))

    @jax.jit
    def step(p, o, b):
        loss, grads = vg(p, b)
        lr = jadamw.cosine_lr(o.step, 3e-4, warmup=100, total=10_000)
        p, o, info = jadamw.adamw_update(p, grads, o, lr=lr)
        return p, o, loss, info["grad_norm"], lr

    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    loss0, grads = vg(params, jb[0])
    out = {"loss0": float(loss0), "grads": to_numpy_tree(grads),
           "steps": [], "init": to_numpy_tree(params)}
    p, o = params, jadamw.adamw_init(params)
    for b in jb:
        p, o, loss, gnorm, lr = step(p, o, b)
        out["steps"].append((float(loss), float(gnorm), to_numpy_tree(p),
                             float(lr)))
    return out


@pytest.fixture(scope="module")
def run():
    """Both meshes' ranks start first (each once), the reference runs
    here meanwhile, then the ranks are joined."""
    ins = {a: inputs(a, i) for i, a in enumerate(ARCHS)}
    trees = {a: ins[a][1] for a in ARCHS}
    batches = {a: ins[a][2] for a in ARCHS}
    dense = ranks.DENSE
    handles = {
        "2x2": launch(ranks.mesh_2x2, (2, 2), ("data", "model"),
                      (trees, batches), timeout_s=300),
        "pod": launch(ranks.mesh_pod, (2, 1, 2), ("pod", "data", "model"),
                      ({dense: trees[dense]}, {dense: batches[dense]}),
                      timeout_s=300)}
    try:
        ref = {a: reference(a, ins[a][0], ins[a][2]) for a in ARCHS}
    finally:
        got = {k: h.join()[0] for k, h in handles.items()}
    return ref, got


def check_against_reference(got, want):
    """Loss, grad norm, gradients and updates (see the module doc)."""
    assert abs(got["loss0"] - want["loss0"]) <= LOSS_RTOL * abs(
        want["loss0"])
    assert_trees_close(got["grads"], want["grads"], GRAD_RTOL, GRAD_FLOOR)
    wg = flat_numpy(want["grads"])
    top = max(float(np.abs(g).max()) for g in wg.values())
    # under the floor: the values whose two gradients differ by more than
    # 1e-4 of their own size (rounding noise, as the key biases' and
    # those within the gradient check's floor), which Adam's normalised
    # step magnifies to its full size
    gg = flat_numpy(got["grads"])
    noise = {k: (np.abs(g) <= GRAD_FLOOR * top)
             | (np.abs(gg[k] - g) > GRAD_RTOL * np.abs(g))
             for k, g in wg.items()}
    init = flat_numpy(want["init"])
    prev_got = init
    for (gl, gn, gp), (wl, wn, wp, lr) in zip(got["steps"], want["steps"]):
        assert abs(gl - wl) <= LOSS_RTOL * abs(wl), (gl, wl)
        assert abs(gn - wn) <= LOSS_RTOL * abs(wn), (gn, wn)
        gp = flat_numpy(gp)
        for k, under in noise.items():
            step = np.abs(gp[k] - prev_got[k])[under]
            if step.size:
                bound = lr * (1 + 0.1 * float(np.abs(prev_got[k]).max()))
                assert step.max() <= bound * (1 + 1e-5) + 1e-12, (k, bound)
        prev_got = gp
    got_p, want_p = flat_numpy(got["steps"][-1][2]), flat_numpy(
        want["steps"][-1][2])
    for k, w in want_p.items():
        du_w, du_g = w - init[k], got_p[k] - init[k]
        err = np.where(noise[k], 0.0, np.abs(du_g - du_w)).max()
        # each step rounds the f32 parameter: an ulp of it a step on top
        ulps = len(want["steps"]) * float(np.spacing(np.abs(w).max()))
        assert err <= UPDATE_RTOL * float(np.abs(du_w).max()) + ulps, (
            k, err, float(np.abs(du_w).max()), ulps)


@pytest.mark.parametrize("executor", EXECUTORS)
def test_dense_step_on_2x2_matches_reference(run, executor):
    ref, got = run
    check_against_reference(got["2x2"][executor], ref[ranks.DENSE])


@pytest.mark.parametrize("arch", (ranks.TIED, ranks.MOE, ranks.VLM))
def test_tied_moe_and_vlm_steps_on_2x2_match_reference(run, arch):
    ref, got = run
    check_against_reference(got["2x2"][arch], ref[arch])


@pytest.mark.parametrize("executor", EXECUTORS)
def test_pod_mesh_step_matches_reference(run, executor):
    ref, got = run
    check_against_reference(got["pod"][executor], ref[ranks.DENSE])
    calls, nbytes = got["pod"][executor]["sites"]["grad_sync"]
    assert calls > 0 and nbytes > 0


def test_operator_centric_moves_at_least_sub_operators_bytes(run):
    got = run[1]["2x2"]
    oc = got["operator_centric"]["bytes"]
    so = got["sub_operator"]["bytes"]
    assert oc >= so > 0, (oc, so)
    # the fsdp gathers run in the forward and again in the remat; their
    # gradients are reduce-scattered once
    calls, _ = got["sub_operator"]["sites"]["fsdp_gather"]
    grad_calls, _ = got["sub_operator"]["sites"]["fsdp_gather.grad"]
    assert calls > grad_calls > 0


def test_pipeline_and_recurrent_families_on_a_mesh_raise(run):
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.execution import make_step
    from repro_torch.launch.train import train

    class Mesh:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 1, "model": 2}
        devices_shape = (2, 1, 2)
        size = 4
        rank = 0
        device = torch.device("cpu")
    shape = ShapeConfig("t", 16, 4, "train")
    # the pipeline over the pod axis serves decode only, as the reference's
    with pytest.raises(NotImplementedError, match="PP is implemented for "
                       "decode"):
        make_step(get_config(ranks.DENSE).reduced(), shape, Mesh(),
                  pod_strategy="pp")
    # the recurrent families train on a mesh: one step of reduced mamba2
    # through train(mesh=...) on the (2, 1, 2) ranks gave a finite loss
    losses = run[1]["pod"]["mamba2_train"]
    assert [s for s, _ in losses] == [1] and np.isfinite(losses[0][1])


@pytest.mark.parametrize("rows, F", ((512, 4864), (1024, 2432)))
def test_ffn_plan_covers_one_ranks_training_shapes(rows, F):
    """K3's plan at one rank's qwen2-0.5b training shapes (4 x 256 tokens
    on (2, 1): 512 rows of all of F; on (1, 2): 1,024 rows of half of F),
    bf16 and f32: 64-row tiles within the shared memory, every row, F
    column and D column covered."""
    from repro_torch.kernels.fused_ffn.ops import COLS, SMEM_BYTES, ffn_plan
    for itemsize in (2, 4):
        plan = ffn_plan(rows, 896, F, itemsize)
        assert plan.rows == 64
        assert max(plan.gate_up_smem, plan.down_smem) <= SMEM_BYTES
        gx, gy, gz = plan.grid_gate_up
        assert gx * COLS >= F and gy * plan.rows >= rows
        assert gz * plan.d_chunk >= 896
        dx, dy, dz = plan.grid_down
        assert dx * COLS >= 896 and dz * plan.f_chunk >= F


def test_each_rank_takes_its_rows_of_the_global_stream():
    """On a (2, 2) mesh the data rows d of the global batch go to the
    ranks of data row d (``ShardingCtx.batch_rows``, the rows the train
    step's ``batch_local`` keeps); the stream is the reference's at any
    mesh shape."""
    import types
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.models.sharding import ShardingCtx, fsdp, sub_operator
    cfg = get_config(ranks.DENSE).reduced()
    want = JaxData(jcfg(ranks.DENSE), 4, 16, seed=3).batch_at(5)
    for d in (0, 1):
        mesh = types.SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 2, "model": 2},
            size=4, index=lambda axes, d=d: d if tuple(axes) == ("data",)
            else 0)
        ctx = ShardingCtx(mesh, fsdp(sub_operator(False)))
        lo, hi = ctx.batch_rows(4)
        assert (lo, hi) == (2 * d, 2 * d + 2)
        got = SyntheticLMData(cfg, 4, 16, seed=3, rows=(lo, hi)).batch_at(5)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k][lo:hi])
        local = ctx.batch_local(torch.from_numpy(want["tokens"]))
        np.testing.assert_array_equal(local.numpy(), want["tokens"][lo:hi])
