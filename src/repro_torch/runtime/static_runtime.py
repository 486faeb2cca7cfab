"""Named-step registry: the port of ``repro.runtime.static_runtime``.

The reference AOT-compiles each serving program once and counts its
dispatches. PyTorch runs eagerly, so here a "program" is a registered
callable: ``compiles`` counts registrations (1 per name, the reference's
zero-retracing invariant) and ``calls`` counts dispatches. ``stats()`` has
the reference's shape. CUDA-graph capture per program is later work.

Every step runs through an optional dispatch interceptor (fault injection,
``set_interceptor``) before its body, as in the reference.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


class DispatchError(RuntimeError):
    """A program dispatch failed before its body ran (a transient launch
    hiccup, an injected fault). Raised by a dispatch interceptor BEFORE the
    step touches its operands, so the caches it would update in place are
    intact and the caller may retry the dispatch verbatim. The serving
    engine's retry/quarantine path catches exactly this type; any other
    exception (a CUDA error, a failed kernel build or launch) is a real
    fault and propagates."""


@dataclass
class CompiledStep:
    name: str
    fn: Callable
    calls: int = 0
    # runs before the body with the program name; raising DispatchError
    # models a dispatch that never reached the device (operands untouched,
    # retry-safe). Installed on every step by StaticRuntime.set_interceptor.
    interceptor: Optional[Callable[[str], None]] = None
    # program metadata merged into its stats() record (the WA backend's
    # overlap depth, when > 1)
    meta: Optional[Dict[str, Any]] = None

    def __call__(self, *args, **kw):
        self.dispatch_elsewhere()
        return self.fn(*args, **kw)

    def dispatch_elsewhere(self):
        """This rank's side of a dispatch whose body runs on other ranks
        of a mesh (a slot of another data row): the interceptor runs and
        the call counts, as on the ranks that run the body, so a seeded
        fault injector draws the same stream and counts the same calls on
        every rank."""
        if self.interceptor is not None:
            self.interceptor(self.name)
        self.calls += 1


class StaticRuntime:
    """Step registry keyed by program name."""

    def __init__(self):
        self._steps: Dict[str, CompiledStep] = {}
        self._interceptor: Optional[Callable[[str], None]] = None

    def set_interceptor(self, fn: Optional[Callable[[str], None]]):
        """Install (or clear, with None) a dispatch interceptor on every
        step, existing and future. It runs at the top of each dispatch with
        the program name: raising ``DispatchError`` models a failed
        dispatch, sleeping a stalled one (the chaos harness,
        ``repro_torch.runtime.faults``, injects through here)."""
        self._interceptor = fn
        for step in self._steps.values():
            step.interceptor = fn

    @contextlib.contextmanager
    def recording(self):
        """Yield a list that collects, in order, the names of the steps
        dispatched inside the block (a dispatch the interceptor refused
        included): what a rank that ran a program's body tells the ranks
        that did not (``CompiledStep.dispatch_elsewhere``)."""
        names: List[str] = []
        inner = self._interceptor

        def record(name):
            names.append(name)
            if inner is not None:
                inner(name)
        self.set_interceptor(record)
        try:
            yield names
        finally:
            self.set_interceptor(inner)

    def step(self, name: str) -> CompiledStep:
        return self._steps[name]

    def step_names(self) -> List[str]:
        """The registered names in registration order (the same on every
        rank of a mesh, which builds the same programs)."""
        return list(self._steps)

    def compile_step(self, name: str, fn: Callable,
                     meta: Optional[Dict[str, Any]] = None) -> CompiledStep:
        """Register ``fn`` under ``name`` once; a second registration of
        the same name returns the first step (programs persist across
        engine runs). ``meta`` is merged into the step's ``stats()``
        record."""
        if name not in self._steps:
            self._steps[name] = CompiledStep(
                name, fn, interceptor=self._interceptor,
                meta=dict(meta) if meta else None)
        return self._steps[name]

    def stats(self) -> Dict[str, Dict]:
        """Per-step ``{"compiles", "compile_s", "calls"}`` plus the step's
        ``meta``; nothing is compiled ahead of time, so ``compile_s`` is
        0."""
        out = {}
        for name, s in self._steps.items():
            out[name] = {"compiles": 1, "compile_s": 0.0, "calls": s.calls}
            if s.meta:
                out[name].update(s.meta)
        return out
