"""Elastic scaling, fault tolerance and straggler mitigation: the port's
own copy of ``repro.runtime.elastic`` (pure Python; the port imports
nothing of the reference package).

The controller runs the standard recovery loop of a data-parallel job:

  detect (health probe / timeout) -> exclude the failed domain -> re-mesh
  to the largest valid (data', model) grid -> rebuild the step -> restore
  the latest checkpoint -> resume (the deterministic data pipeline replays
  from the restored step).

The data axis shrinks (data parallelism is elastic); the model axis is
kept, because tensor-parallel weights assume that divisor. Stragglers: a
step's duration feeds an EWMA; a step slower than ``straggler_factor`` x
the EWMA marks its domain suspect, and after ``patience`` marks in a row
the domain is treated as failed and excluded.

Failures are injected (``inject_failure``), and ``recover`` calls the
caller's ``make_mesh``, ``recompile`` and ``restore``. On one device
they rebuild the step and restore from the port's checkpointer, after
which ``launch.train.train``, started again on the same checkpoint
directory, resumes the data from the restored step. On real ranks
(``remesh``) the
new mesh is a new set of ``torch.distributed`` ranks at ``mesh_shape()``
(``repro_torch.launch.mesh``), each of which builds its step, restores the
latest checkpoint (whole, written by rank 0 of the old mesh) and cuts its
own shards from it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class NodeFailure(RuntimeError):
    def __init__(self, domain: int, reason: str = "health-probe"):
        super().__init__(f"domain {domain} failed ({reason})")
        self.domain = domain
        self.reason = reason


@dataclass
class ElasticController:
    n_data: int                       # current data-axis size
    n_model: int                      # fixed model-axis size
    n_pod: int = 1
    ewma_alpha: float = 0.2
    straggler_factor: float = 3.0
    patience: int = 3
    min_data: int = 1
    failed_domains: List[int] = field(default_factory=list)
    _ewma: Optional[float] = None
    _suspect: Dict[int, int] = field(default_factory=dict)
    events: List[str] = field(default_factory=list)

    # ------------------------------------------------------------------
    @property
    def healthy_data(self) -> int:
        return self.n_data - len(self.failed_domains)

    def mesh_shape(self) -> Tuple[int, ...]:
        """Largest valid mesh after failures: data axis rounded down to a
        power-of-two-friendly divisor of the batch."""
        d = self.healthy_data
        # keep data a divisor of the original (batch divisibility)
        while d > self.min_data and self.n_data % d != 0:
            d -= 1
        d = max(d, self.min_data)
        if self.n_pod > 1:
            return (self.n_pod, d, self.n_model)
        return (d, self.n_model)

    # ------------------------------------------------------------------
    def inject_failure(self, domain: int, reason: str = "injected"):
        if domain not in self.failed_domains:
            self.failed_domains.append(domain)
            self.events.append(f"FAIL domain={domain} reason={reason}")

    def observe_step(self, duration_s: float,
                     slow_domain: Optional[int] = None) -> Optional[int]:
        """Feed one step duration; returns a domain to evict, or None."""
        if self._ewma is None:
            self._ewma = duration_s
            return None
        if duration_s > self.straggler_factor * self._ewma \
                and slow_domain is not None:
            self._suspect[slow_domain] = self._suspect.get(slow_domain, 0) + 1
            self.events.append(
                f"STRAGGLER domain={slow_domain} "
                f"x{duration_s / self._ewma:.1f} "
                f"strike={self._suspect[slow_domain]}")
            if self._suspect[slow_domain] >= self.patience:
                self.inject_failure(slow_domain, "straggler")
                del self._suspect[slow_domain]
                return slow_domain
        else:
            self._ewma = (1 - self.ewma_alpha) * self._ewma \
                + self.ewma_alpha * duration_s
        return None

    # ------------------------------------------------------------------
    def recover(self, make_mesh: Callable[[Tuple[int, ...]], object],
                recompile: Callable[[object], object],
                restore: Callable[[object], Tuple[int, object]]):
        """Run the recovery loop; returns (mesh, step, state, compiled)."""
        shape = self.mesh_shape()
        self.events.append(f"REMESH shape={shape}")
        mesh = make_mesh(shape)
        compiled = recompile(mesh)
        step, state = restore(mesh)
        self.events.append(f"RESUME step={step}")
        return mesh, step, state, compiled


def remesh(controller: ElasticController,
           start: Callable[[Tuple[int, ...]], Any], ckpt_dir: str):
    """``controller.recover`` on real ranks: ``make_mesh`` is
    ``start(shape)``, which launches the ranks of the new mesh (a
    ``launch.mesh.Launch`` whose ranks restore the latest checkpoint in
    ``ckpt_dir`` and resume); each rank builds its own step
    (``recompile`` hands the launch on); ``restore`` joins the ranks.
    Returns (the new mesh's shape, the checkpoint's step it resumed from,
    the ranks' results in rank order)."""
    from repro_torch.checkpoint.checkpointer import latest_step
    step = latest_step(ckpt_dir)
    if step is None:
        raise RuntimeError(f"elastic: no checkpoint in {ckpt_dir} to "
                           "restore the new mesh from")
    shape = controller.mesh_shape()
    _, step, results, _ = controller.recover(
        make_mesh=start, recompile=lambda launched: launched,
        restore=lambda launched: (step, launched.join()))
    return shape, step, results
