"""Static schedules of the weight–attention (WA) layer loop: the schedule
part of ``repro.core.pipeline``.

``skewed_schedule`` is the software-pipeline pattern the WA backend's
overlapped decode follows (participant m runs op t - m at tick t);
``wa_schedule_occupancy`` is its per-domain occupancy, the schedule
arithmetic behind ``stats()["wa"]``. Plain Python integers, no device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

Schedule = List[Tuple[int, List[Tuple[int, int]]]]


def skewed_schedule(n_ops: int, depth: int) -> Schedule:
    """Static software-pipeline schedule: ``depth`` participants each run
    the same chain of ``n_ops`` ops, participant ``m`` skewed ``m`` ticks
    behind participant 0. Returns ``[(tick, [(m, op), ...]), ...]`` over
    ``n_ops + depth - 1`` ticks; at each tick the live participants hold
    consecutive op indices (op = tick - m), so for an alternating
    two-domain op chain adjacent participants occupy opposite domains."""
    if n_ops < 1 or depth < 1:
        raise ValueError(f"need n_ops >= 1 and depth >= 1, got "
                         f"({n_ops}, {depth})")
    return [(t, [(m, t - m) for m in range(depth) if 0 <= t - m < n_ops])
            for t in range(n_ops + depth - 1)]


def wa_schedule_occupancy(n_layers: int, depth: int) -> Dict[str, Any]:
    """Per-domain occupancy of the skewed WA decode schedule: the op chain
    is 2L+1 alternating ops (even = W: embed/QKV/FFN/unembed, odd = A:
    attention), so a tick is W-busy (A-busy) when a live micro-batch holds
    an even (odd) op. Depth 1 is the sequential loop (``overlap_efficiency``
    ~0.5); depth >= 2 keeps both domains busy on every interior tick."""
    sched = skewed_schedule(2 * n_layers + 1, depth)
    w_busy = sum(1 for _t, live in sched
                 if any(op % 2 == 0 for _m, op in live))
    a_busy = sum(1 for _t, live in sched
                 if any(op % 2 == 1 for _m, op in live))
    total = len(sched)
    return {
        "total_ticks": total,
        "w_busy_ticks": w_busy,
        "a_busy_ticks": a_busy,
        "w_idle_frac": (total - w_busy) / total,
        "a_idle_frac": (total - a_busy) / total,
        "overlap_efficiency": (w_busy + a_busy) / (2 * total),
    }
