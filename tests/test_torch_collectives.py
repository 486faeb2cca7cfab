"""``repro_torch.core.collectives`` over a (2, 2) ("data", "model") mesh of
four gloo ranks (one launch, one intra-op thread each):

- ``hierarchical_psum`` (fast "model", slow "data") equals a flat
  all-reduce within 1e-6, and moves at most the flat bytes / |fast| over
  the slow axis; ``hierarchical_pmean`` is the mean;
- ``ring_all_gather`` (n-1 send/recv steps) equals ``all_gather`` on
  either axis and either dim;
- ``reduce_scatter``, ``grad_sync`` and the control group's broadcast and
  gather give what they must, and the control calls are counted apart;
- ``make_test_mesh`` lays ranks out row-major, ``make_production_mesh``
  refuses a world of the wrong size;
- under autograd each collective's backward is its transpose over the
  ranks (all-gather <-> reduce-scatter, all-reduce <-> all-reduce), and
  Megatron's f (``copy_to``: identity, the gradient all-reduced) and g
  (``reduce_from``: an all-reduce, the gradient passed on), metered at
  the site's ".grad";

and, without processes, the routing table: which (backend, device type)
pairs carry which collectives straight through, which are staged, and
that a pair nothing can carry raises; and that ranks share one card only
when the caller asks for it.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks                             # noqa: E402
from repro_torch.core import collectives as C                # noqa: E402
from repro_torch.launch.mesh import spawn                    # noqa: E402


@pytest.fixture(scope="module")
def res():
    return spawn(ranks.collectives, (2, 2), ("data", "model"),
                 timeout_s=180)


def _total(res):
    return sum(r["x"] for r in res)


def test_hierarchical_psum_equals_flat_sum(res):
    want = _total(res)
    for r in res:
        torch.testing.assert_close(r["flat"], want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(r["hier"], r["flat"], rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(r["mean"], want / 4, rtol=1e-6,
                                   atol=1e-6)


def test_hierarchical_slow_axis_bytes_at_most_flat_over_fast(res):
    for r in res:
        assert 0 < r["slow_bytes"] <= r["flat_bytes"] / 2, \
            (r["slow_bytes"], r["flat_bytes"])


@pytest.mark.parametrize("axis", ("model", "data"))
def test_ring_all_gather_equals_all_gather(res, axis):
    for r in res:
        assert torch.equal(r[f"ring_{axis}"], r[f"gather_{axis}"])
        assert torch.equal(r[f"ring1_{axis}"], r[f"gather1_{axis}"])
        assert r[f"gather_{axis}"].shape == (4, 3)


def test_reduce_scatter_is_this_ranks_block_of_the_sum(res):
    for r in res:
        line = [q for q in res if q["coords"]["data"] == r["coords"]["data"]]
        total = sum(q["x"] for q in line)
        m = r["coords"]["model"]
        torch.testing.assert_close(r["rs"], total[m * 4:(m + 1) * 4])


def test_grad_sync_means_over_the_data_axis(res):
    for r in res:
        col = [q for q in res
               if q["coords"]["model"] == r["coords"]["model"]]
        mean = sum(q["x"] for q in col) / 2
        torch.testing.assert_close(r["grad_sync"]["a"], mean)
        torch.testing.assert_close(r["grad_sync"]["b"][0], 2 * mean)


def test_control_group_broadcast_and_gather(res):
    for r in res:
        assert r["bcast"].tolist() == [10]                   # rank 3 + 7
        col = sorted(q["coords"]["data"] * 2 + q["coords"]["model"]
                     for q in res
                     if q["coords"]["model"] == r["coords"]["model"])
        assert r["cgather"].reshape(-1).tolist() == col
        assert r["control_calls"] == 2


def test_backend_routing_table():
    def mesh(backend):
        return types.SimpleNamespace(backend=backend)

    def tensor(kind):
        return types.SimpleNamespace(device=types.SimpleNamespace(type=kind))
    for what in ("all_reduce", "all_gather", "reduce_scatter", "send_recv"):
        assert C._route(tensor("cpu"), mesh("gloo"), what)
        assert C._route(tensor("cuda"), mesh("nccl"), what)
    # gloo on CUDA tensors: collectives straight through, send/recv staged
    assert C._route(tensor("cuda"), mesh("gloo"), "all_reduce")
    assert not C._route(tensor("cuda"), mesh("gloo"), "send_recv")
    with pytest.raises(RuntimeError, match="cannot carry"):
        C._route(tensor("cpu"), mesh("nccl"), "all_reduce")
    with pytest.raises(RuntimeError, match="cannot carry"):
        C._route(tensor("meta"), mesh("gloo"), "all_reduce")


def test_ranks_share_a_card_only_when_asked():
    """More ranks than cards on ``cuda``: ``launch`` and the serve CLI's
    mesh helper raise (before any rank starts) unless ``share_device``
    asks for every rank on ``cuda:0``."""
    from repro_torch.launch.mesh import launch
    from repro_torch.launch.serve import serve_on_mesh
    world = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="share_device=True"):
        launch(ranks.coords_of, (1, world), device="cuda")
    with pytest.raises(RuntimeError, match="share_device=True"):
        serve_on_mesh((1, world), "sub_operator", {}, device="cuda")


def test_mesh_constructors(res):
    """``make_test_mesh`` lays ranks out row-major; the production mesh
    checks only its rank count, as the reference checks its devices."""
    for i, r in enumerate(res):
        coords, data_line = r["test_mesh"]
        assert coords == {"data": i // 2, "model": i % 2} == r["coords"]
        assert data_line == (i % 2, i % 2 + 2)
        assert "need 256 ranks" in r["production_mesh"]


def test_a_failed_rendezvous_is_started_once_more():
    """A rank that cannot join its process groups (here: an unknown
    device) fails the rendezvous; ``Launch`` starts the ranks once more
    from a fresh store."""
    import os
    import pickle
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.launch import mesh as M
    tries = []

    def start(device):
        def go():
            tries.append(device)
            tmp = tempfile.mkdtemp(prefix="mesh-test-")
            with open(os.path.join(tmp, "args.pkl"), "wb") as f:
                pickle.dump((), f)
            ctx = mp.start_processes(
                M._rank_main, args=(ranks.coords_of, (1, 2),
                                    ("data", "model"), device(), False,
                                    tmp, 1, 60),
                nprocs=2, join=False, start_method="spawn")
            return ctx, tmp
        return go
    flaky = iter(["tpu", "cpu"])
    res = M.Launch(start(lambda: next(flaky)), (1, 2), 2, 120).join()
    assert tries and res == [{"data": 0, "model": 0},
                             {"data": 0, "model": 1}]


def _line(res, r):
    """The ranks of r's "model" line, in index order."""
    return [q for q in res if q["coords"]["data"] == r["coords"]["data"]]


def test_collectives_backward_is_their_transpose(res):
    for r in res:
        line = [q["grads"] for q in _line(res, r)]
        me = r["coords"]["model"]
        g = r["grads"]
        rows = g["x"].shape[0]
        want = {
            # y = cat(x_0, x_1) on both: x_j's gradient sums their blocks j
            "all_gather": sum(q["all_gather"]["w"][me * rows:(me + 1)
                                                   * rows] for q in line),
            # y_r = block r of x_0 + x_1: x_j's gradient is every w_r
            "reduce_scatter": torch.cat([q["reduce_scatter"]["w"]
                                         for q in line]),
            "all_reduce": sum(q["all_reduce"]["w"] for q in line),
            "copy_to": sum(q["copy_to"]["w"] for q in line),
            "reduce_from": g["reduce_from"]["w"],
        }
        xs = [q["x"] for q in line]
        torch.testing.assert_close(g["all_gather"]["y"], torch.cat(xs))
        torch.testing.assert_close(g["copy_to"]["y"], g["x"])
        torch.testing.assert_close(g["reduce_from"]["y"], sum(xs))
        for name, dx in want.items():
            torch.testing.assert_close(g[name]["dx"], dx, rtol=1e-6,
                                       atol=1e-6)
            assert g[name]["grad_calls"] == (0 if name == "reduce_from"
                                             else 1), name
