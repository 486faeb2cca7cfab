"""The mesh launcher's wall-clock ceiling (``launch/mesh.py``): ranks that
keep computing and never finish make progress as the progress-based
limits count it (CPU time), so only the ceiling stops them. It kills
every rank within a few seconds of it and raises with each rank's Python
stack."""
import time

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_family_ranks as ranks                      # noqa: E402
from repro_torch.launch import mesh as M                     # noqa: E402


def test_busy_ranks_are_stopped_at_the_wall_clock_ceiling():
    wall = 25.0
    t0 = time.monotonic()
    handle = M.launch(ranks.spin_forever, (1, 2), ("data", "model"),
                      timeout_s=300, wall_s=wall)
    with pytest.raises(TimeoutError, match="wall-clock ceiling") as err:
        handle.join()
    took = time.monotonic() - t0
    assert wall <= took <= wall + 15, took
    msg = str(err.value)
    for r in range(2):
        assert f"-- rank {r}:" in msg
    # each rank's stack shows where it was spinning
    assert msg.count("spin_forever") == 2, msg[-2000:]
    assert not any(p.is_alive() for p in handle.ctx.processes)


def test_the_ceiling_defaults_above_the_progress_limits():
    """The default ceiling leaves the progress-based limits as they were
    (no limit shortened) and is a few times a mesh test module's run."""
    import inspect
    assert M.INIT_S == 120.0
    sig = inspect.signature(M.launch)
    assert sig.parameters["timeout_s"].default == 300.0
    assert sig.parameters["wall_s"].default == M.WALL_S >= 300.0
