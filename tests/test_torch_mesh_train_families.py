"""The recurrent and enc-dec families trained on a mesh of gloo ranks
against the JAX reference's single-device step, the same weights on both
sides (the reference's parameters through ``repro_torch.interop``),
reduced configs in float32 (recurrentgemma at 4 layers, one superblock
and one recurrent tail layer, with a window of 8 against a 16-token
sequence), a global batch of 4 x 16 tokens (whisper's with its 16 frames)
from the reference's seeded synthetic data:

- ``make_step(mode="train")`` (the executor's rules under fsdp) of
  mamba2, recurrentgemma and whisper on a (2, 2) ("data", "model") mesh
  under each executor, and of whisper on a (2, 1, 2) ("pod", "data",
  "model") mesh with the pod axis a data axis: two AdamW steps against
  ``jax.value_and_grad`` of the reference's ``build_model(cfg).loss`` and
  ``adamw_update``, with ``test_torch_mesh_train.py``'s checks (the loss
  and the grad norm within 1e-5, every gradient leaf within 1e-4 of its
  max, the updates within 1e-3 of each leaf's max |update|);
- recurrentgemma trains two steps on (2, 2) with a checkpoint at step 2,
  ``runtime.elastic.remesh`` starts a (1, 2) mesh that restores it and
  trains step 3: the loss, the parameters and AdamW's moments equal three
  uninterrupted steps on (1, 2).

Each mesh's ranks start once (module fixtures), one intra-op thread
each, while the reference runs here.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
import numpy as np                                           # noqa: E402

import torch_mesh_train_ranks as ranks                       # noqa: E402
from repro.configs.registry import get_config as jget        # noqa: E402
from repro.data.synthetic import SyntheticLMData as JaxData  # noqa: E402
from repro.models import build_model as jbuild               # noqa: E402
from repro_torch.interop import tree_to_numpy                # noqa: E402
from repro_torch.launch.mesh import launch                   # noqa: E402
from repro_torch.runtime.elastic import (ElasticController,  # noqa: E402
                                         remesh)
from test_torch_mesh import to_numpy_tree                    # noqa: E402
from test_torch_mesh_train import (EXECUTORS,                # noqa: E402
                                   check_against_reference, reference)
from test_torch_train import (GRAD_FLOOR, GRAD_RTOL,        # noqa: E402
                              flat_numpy)

STEPS = 2
UPDATE_RTOL = 1e-3


def jcfg(arch):
    return ranks.family_overrides(jget(arch).reduced()
                                  .replace(dtype="float32"))


def inputs(arch, seed):
    """The reference's weights (JAX and numpy) and its batches (numpy)."""
    params = jax.jit(jbuild(jcfg(arch)).init)(jax.random.key(seed))
    data = JaxData(jcfg(arch), ranks.B, ranks.S, seed=3)
    return params, to_numpy_tree(params), [data.batch_at(i)
                                           for i in range(STEPS)]


@pytest.fixture(scope="module")
def run():
    """Both meshes' ranks start first (each once), the reference runs
    here meanwhile, then the ranks are joined."""
    ins = {a: inputs(a, 30 + i) for i, a in enumerate(ranks.FAMILIES)}
    trees = {a: ins[a][1] for a in ranks.FAMILIES}
    batches = {a: ins[a][2] for a in ranks.FAMILIES}
    handles = {
        "2x2": launch(ranks.families_2x2, (2, 2), ("data", "model"),
                      (trees, batches), timeout_s=300),
        "pod": launch(ranks.families_pod, (2, 1, 2),
                      ("pod", "data", "model"), (trees, batches),
                      timeout_s=300)}
    try:
        ref = {a: reference(a, ins[a][0], ins[a][2], jcfg(a))
               for a in ranks.FAMILIES}
    finally:
        got = {k: h.join()[0] for k, h in handles.items()}
    return ref, got


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("arch", ranks.FAMILIES)
def test_family_step_on_2x2_matches_reference(run, arch, executor):
    ref, got = run
    out = got["2x2"][(arch, executor)]
    check_against_reference(out, ref[arch])
    # the layers' fsdp gathers run in the forward and again in the remat;
    # their gradients are reduce-scattered once
    calls, _ = out["sites"]["fsdp_gather"]
    grad_calls, _ = out["sites"]["fsdp_gather.grad"]
    assert calls > grad_calls > 0


def test_family_step_on_pod_mesh_matches_reference(run):
    ref, got = run
    out = got["pod"][(ranks.AUDIO, "sub_operator")]
    check_against_reference(out, ref[ranks.AUDIO])
    calls, nbytes = out["sites"]["grad_sync"]
    assert calls > 0 and nbytes > 0


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck"))
    kw = dict(steps=2, batch=ranks.B, seq=ranks.S, log_every=1, seed=0,
              ckpt_dir=ck, ckpt_every=2)
    whole = launch(ranks.train_run, (1, 2), ("data", "model"),
                   (dict(kw, steps=3, ckpt_dir=None), None, ranks.HYBRID,
                    True), timeout_s=300)
    first = launch(ranks.train_run, (2, 2), ("data", "model"),
                   (kw, None, ranks.HYBRID), timeout_s=300)
    first.join()
    ec = ElasticController(n_data=2, n_model=2)
    ec.inject_failure(1)
    shape, step, res = remesh(
        ec, lambda shape: launch(ranks.train_run, shape, ("data", "model"),
                                 (dict(kw, steps=3), None, ranks.HYBRID,
                                  True), timeout_s=300), ck)
    return {"want": whole.join()[0], "got": res[0], "shape": shape,
            "step": step}


def test_hybrid_checkpoint_on_2x2_resumes_on_1x2(ckpt_runs):
    """Two steps on (2, 2), a checkpoint, ``remesh`` to (1, 2) and one
    more step: the loss of step 3 within 1e-5, the parameters within 1e-3
    of each leaf's max |update| (plus an f32 ulp of the leaf a step), and
    AdamW's moments (sums of gradients taken on two meshes) within the
    gradient tolerance, against three steps on (1, 2)."""
    assert ckpt_runs["shape"] == (1, 2) and ckpt_runs["step"] == 2
    want_losses, want_p, want_o = ckpt_runs["want"]
    got_losses, got_p, got_o = ckpt_runs["got"]
    assert [s for s, _ in got_losses] == [3]
    assert abs(got_losses[0][1] - want_losses[2][1]) <= 1e-5 * abs(
        want_losses[2][1])
    init = flat_numpy(tree_to_numpy(ranks.full_init(ranks.HYBRID)))
    got_p, want_p = flat_numpy(got_p), flat_numpy(want_p)
    assert sorted(got_p) == sorted(want_p)
    for k, w in want_p.items():
        du_w, du_g = w - init[k], got_p[k] - init[k]
        ulps = 3 * float(np.spacing(np.abs(w).max()))
        err = float(np.abs(du_g - du_w).max())
        assert err <= UPDATE_RTOL * float(np.abs(du_w).max()) + ulps, (
            k, err)
    assert int(got_o["step"]) == int(want_o["step"]) == 3
    for m in ("mu", "nu"):
        g, w = flat_numpy(got_o[m]), flat_numpy(want_o[m])
        top = max(float(np.abs(v).max()) for v in w.values())
        for k, wv in w.items():
            err = float(np.abs(g[k] - wv).max())
            assert err <= GRAD_RTOL * float(np.abs(wv).max()) \
                + GRAD_FLOOR * top, (m, k, err)


def test_each_rank_takes_its_rows_of_whisper_frames():
    """On a (2, 2) mesh the ranks of data row d take rows [2d, 2d + 2) of
    the global batch, whisper's frames with its tokens and labels
    (``SyntheticLMData(rows=...)``), the reference's bytes; the train
    step's ``batch_local`` cuts a whole batch's frames the same way."""
    import types

    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.models.sharding import ShardingCtx, fsdp, sub_operator
    cfg = ranks.train_cfg(ranks.AUDIO)
    want = JaxData(jcfg(ranks.AUDIO), 4, 16, seed=3).batch_at(2)
    assert want["frames"].shape == (4, cfg.encoder.n_frames, cfg.d_model)
    for d in (0, 1):
        mesh = types.SimpleNamespace(
            axis_names=("data", "model"), shape={"data": 2, "model": 2},
            size=4, index=lambda axes, d=d: d if tuple(axes) == ("data",)
            else 0)
        ctx = ShardingCtx(mesh, fsdp(sub_operator(False)))
        lo, hi = ctx.batch_rows(4)
        got = SyntheticLMData(cfg, 4, 16, seed=3, rows=(lo, hi)).batch_at(2)
        assert sorted(got) == ["frames", "labels", "tokens"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k][lo:hi])
        local = ctx.batch_local(torch.from_numpy(want["frames"]))
        np.testing.assert_array_equal(local.numpy(), want["frames"][lo:hi])
