"""Checkpoints that move between meshes, and the elastic re-mesh on real
ranks (gloo, on the CPU), with ``launch.train.train(mesh=...)`` of
reduced internlm2-1.8b in float32, 4 steps of a global batch of 4 x 16:

- a (2, 2) run checkpoints at step 2; the ranks of data row 1 raise
  ``NodeFailure`` as step 3 starts (the launcher stops the other ranks);
  ``ElasticController.recover`` (``runtime.elastic.remesh``) starts a
  (1, 2) mesh of new ranks, which restore the checkpoint, cut their own
  shards from it and resume to step 4: the final parameters equal an
  uninterrupted (2, 2) run's within 1e-3 of each leaf's max |update| (plus
  an f32 ulp of the leaf a step), the losses of steps 3-4 within 1e-5;
- the checkpoint the mesh wrote (rank 0, the whole tree) restores through
  the reference's ``restore_pytree`` to the tree that the port's
  single-device ``train`` wrote at the same step: the parameters and the
  step within 1e-6 of each leaf's largest value; AdamW's moments, which
  are the gradients (summed over ranks in another order, so equal to
  rounding: 1.1e-6 of a leaf's largest value was seen), within the
  gradient tolerance of ``test_torch_train.py`` (1e-4 of the leaf's
  largest value plus 1e-6 of the moment tree's);
- ``python -m repro_torch.launch.train --mesh 2x2 --device cpu`` runs and
  prints the losses of ``train(device="cpu")``.
"""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                      # noqa: E402
import numpy as np                                           # noqa: E402

import torch_mesh_train_ranks as ranks                       # noqa: E402
from repro.checkpoint import checkpointer as jckpt           # noqa: E402
from repro_torch.checkpoint.checkpointer import latest_step  # noqa: E402
from repro_torch.interop import tree_to_numpy                # noqa: E402
from repro_torch.launch.mesh import launch                   # noqa: E402
from repro_torch.launch.train import train                   # noqa: E402
from repro_torch.runtime.elastic import (ElasticController,  # noqa: E402
                                         remesh)
from test_torch_train import (GRAD_FLOOR, GRAD_RTOL,        # noqa: E402
                              flat_numpy)

KW = dict(steps=4, batch=ranks.B, seq=ranks.S, log_every=1, seed=0)
UPDATE_RTOL = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's runs in this process (the
    ranks take one each); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck"))
    kw = dict(KW, ckpt_dir=ck, ckpt_every=2)
    whole = launch(ranks.train_run, (2, 2), ("data", "model"), (KW,),
                   timeout_s=300)
    failing = launch(ranks.train_run, (2, 2), ("data", "model"),
                     (kw, (1, 3)), timeout_s=300)
    want = whole.join()[0]
    with pytest.raises(RuntimeError, match="domain 1 failed") as failed:
        failing.join()
    ec = ElasticController(n_data=2, n_model=2)
    ec.inject_failure(1)
    shape, step, res = remesh(
        ec, lambda shape: launch(ranks.train_run, shape, ("data", "model"),
                                 (kw,), timeout_s=300), ck)
    return {"want": want, "got": res[0], "shape": shape, "step": step,
            "events": ec.events, "error": str(failed.value), "ck": ck}


def test_remesh_resumes_to_the_uninterrupted_run(runs):
    assert runs["shape"] == (1, 2) and runs["step"] == 2
    assert runs["events"] == ["FAIL domain=1 reason=injected",
                              "REMESH shape=(1, 2)", "RESUME step=2"]
    assert "NodeFailure: domain 1 failed (injected)" in runs["error"]
    want_losses, want_p = runs["want"]
    got_losses, got_p = runs["got"]
    assert [s for s, _ in got_losses] == [3, 4]
    for (s, g), (_, w) in zip(got_losses, want_losses[2:]):
        assert abs(g - w) <= 1e-5 * abs(w), (s, g, w)
    init = flat_numpy(tree_to_numpy(ranks.full_init()))
    got_p, want_p = flat_numpy(got_p), flat_numpy(want_p)
    for k, w in want_p.items():
        du_w, du_g = w - init[k], got_p[k] - init[k]
        ulps = KW["steps"] * float(np.spacing(np.abs(w).max()))
        err = float(np.abs(du_g - du_w).max())
        assert err <= UPDATE_RTOL * float(np.abs(du_w).max()) + ulps, (
            k, err)


def _reference_template(tree):
    """``tree`` (port tensors) as zeros of the reference's arrays, the
    same structure: a template for ``repro``'s ``restore_pytree``."""
    if isinstance(tree, dict):
        return {k: _reference_template(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_reference_template(v) for v in tree]
    return jnp.zeros(tuple(tree.shape), {torch.float32: jnp.float32,
                                         torch.int32: jnp.int32}[tree.dtype])


def test_mesh_checkpoint_restores_in_the_reference_as_single_device(
        runs, tmp_path):
    single = str(tmp_path / "single")
    params, opt, _ = train(ranks.train_cfg(ranks.DENSE), reduced=False,
                           device="cpu", **dict(KW, steps=2,
                                                ckpt_dir=single))
    assert latest_step(single) == 2
    template = _reference_template(
        {"params": params, "opt": {"step": opt.step, "mu": opt.mu,
                                   "nu": opt.nu}})
    a = jckpt.restore_pytree(template, runs["ck"], 2)
    b = jckpt.restore_pytree(template, single, 2)
    fa = dict(tree_paths_np(a))
    fb = dict(tree_paths_np(b))
    assert sorted(fa) == sorted(fb) and len(fa) > 10
    top = {m: max(float(np.abs(v).max()) for k, v in fb.items()
                  if k.startswith(f"/opt/{m}/")) for m in ("mu", "nu")}
    for k, want in fb.items():
        got = fa[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        tol = 1e-6 * float(np.abs(want).max())
        moment = k.split("/")[2] if k.startswith("/opt/") else None
        if moment in top:
            # the moments are sums of the two runs' gradients, which
            # agree to the gradient tolerance, not to the parameters'
            tol = GRAD_RTOL * float(np.abs(want).max()) \
                + GRAD_FLOOR * top[moment]
        assert float(np.abs(got - want).max()) <= tol, k


def tree_paths_np(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths_np(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths_np(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def test_cli_trains_on_a_mesh_with_the_single_device_losses():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         ranks.DENSE, "--mesh", "2x2", "--steps", "2", "--batch", "4",
         "--seq", "16", "--log-every", "1", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = [float(x) for x in re.findall(r"step +\d+ loss ([0-9.]+)",
                                        out.stdout)]
    _, _, losses = train(ranks.DENSE, steps=2, batch=4, seq=16,
                         log_every=1, device="cpu")
    assert len(got) == 2
    for g, (_, w) in zip(got, losses):
        assert abs(g - w) <= 1e-4, (g, w)
