"""Named-step registry: the port of ``repro.runtime.static_runtime``.

The reference AOT-compiles each serving program once and counts its
dispatches. PyTorch runs eagerly, so here a "program" is a registered
callable: ``compiles`` counts registrations (1 per name, the reference's
zero-retracing invariant) and ``calls`` counts dispatches. ``stats()`` has
the reference's shape. CUDA-graph capture per program is later work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict


@dataclass
class CompiledStep:
    name: str
    fn: Callable
    calls: int = 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


class StaticRuntime:
    """Step registry keyed by program name."""

    def __init__(self):
        self._steps: Dict[str, CompiledStep] = {}

    def compile_step(self, name: str, fn: Callable) -> CompiledStep:
        """Register ``fn`` under ``name`` once; a second registration of
        the same name returns the first step (programs persist across
        engine runs)."""
        if name not in self._steps:
            self._steps[name] = CompiledStep(name, fn)
        return self._steps[name]

    def stats(self) -> Dict[str, Dict]:
        """Per-step ``{"compiles", "compile_s", "calls"}``; nothing is
        compiled ahead of time, so ``compile_s`` is 0."""
        return {name: {"compiles": 1, "compile_s": 0.0, "calls": s.calls}
                for name, s in self._steps.items()}
