"""Collectives over the axes of a ``Mesh``: the port of
``repro.core.collectives``, plus the thin wrappers every sharded site
calls, with byte counters per axis and per call site.

Hierarchical (bounded fan-in) reduction, the paper's two-level
synchronization mapped onto mesh axes: a flat all-reduce over (slow x
fast) moves every byte across the slow link; ``hierarchical_psum``
reduce-scatters within the fast axis, all-reduces the 1/|fast| shard across
the slow axis and all-gathers within the fast axis, so the slow axis
carries |fast| times fewer bytes. ``ring_all_gather`` is the explicit ring
built from ``batch_isend_irecv`` (the reference's ``ppermute``);
``grad_sync`` is the training path's gradient reduction over the batch
axes (the train step's, ``core/execution.py``).

Which tensors a backend carries is decided once per (backend, device
type), in ``CARRIES``, never by a retry after a failure:

- ``gloo`` on CPU tensors, ``nccl`` on CUDA tensors: every collective
  straight through;
- ``gloo`` on CUDA tensors (ranks sharing one card): all-reduce,
  all-gather, reduce-scatter, broadcast and all-to-all straight through;
  point-to-point sends (``batch_isend_irecv``) are staged through pinned
  host memory. ``tools/gloo_cuda_probe.py`` found, with torch 2.11 on an
  H100, that the five take CUDA tensors and that gloo's send/recv of a CUDA
  tensor aborts its process (``writev ... Bad address``);
- anything else (``nccl`` on CPU tensors, an unknown backend) raises.

Bytes are what one rank sends under ring algorithms: an all-reduce of N
bytes over n ranks sends 2(n-1)/n N, an all-gather (n-1) times its part, a
reduce-scatter (n-1)/n of its input, a send its tensor. They are counted
per axis key (the axes joined by "+", in mesh order) and per call site in
``mesh.meter``; ``control_*`` calls (CPU tensors on the gloo control group:
the serving engine's lock-step decisions and gathered host results) are
counted apart.
"""
from __future__ import annotations

import warnings
from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# torch 2.13 names these two deprecated in favour of *_single (torch 2.11,
# on the card, has no *_single); the calls are what both versions run
warnings.filterwarnings(
    "ignore", message=r".*(all_gather_into_tensor|reduce_scatter_tensor)"
    r".* is deprecated", category=FutureWarning)

ALL = frozenset({"all_reduce", "all_gather", "reduce_scatter", "broadcast",
                 "all_to_all", "send_recv"})

# (backend, device type) -> the collectives it carries as they are; the
# others are staged through pinned host memory (tools/gloo_cuda_probe.py)
CARRIES = {
    ("gloo", "cpu"): ALL,
    ("gloo", "cuda"): ALL - {"send_recv"},
    ("nccl", "cuda"): ALL,
}


class CollectiveMeter:
    """Bytes sent and calls, per (axis key, site), and the control
    group's traffic."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.bytes: Dict[Tuple[str, str], float] = defaultdict(float)
        self.calls: Dict[Tuple[str, str], int] = defaultdict(int)
        self.control_calls = 0
        self.control_bytes = 0

    def add(self, key: str, site: str, nbytes: float):
        self.bytes[(key, site)] += nbytes
        self.calls[(key, site)] += 1

    def total(self, key: Optional[str] = None) -> float:
        return float(sum(b for (k, _), b in self.bytes.items()
                         if key is None or k == key))

    def stats(self) -> Dict:
        per_axis: Dict[str, float] = defaultdict(float)
        per_site: Dict[str, float] = defaultdict(float)
        for (k, s), b in self.bytes.items():
            per_axis[k] += b
            per_site[s or "-"] += b
        return {"bytes_total": self.total(),
                "bytes_per_axis": dict(per_axis),
                "bytes_per_site": dict(per_site),
                "calls": int(sum(self.calls.values())),
                "control_calls": self.control_calls,
                "control_bytes": self.control_bytes}


def meter(mesh) -> CollectiveMeter:
    m = getattr(mesh, "meter", None)
    if m is None:
        m = mesh.meter = CollectiveMeter()
    return m


def _key(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    axes = tuple(a for a in mesh.axis_names if a in axes)
    return axes


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _route(x: torch.Tensor, mesh, what: str) -> bool:
    """True: the backend carries ``what`` on x's device as it is; False:
    stage through pinned host memory. Raises where nothing can carry it."""
    carried = CARRIES.get((mesh.backend, x.device.type))
    if carried is None:
        raise RuntimeError(
            f"the {mesh.backend!r} backend cannot carry {x.device.type} "
            f"tensors ({what}); use gloo for CPU tensors and ranks sharing "
            "a card, nccl for one card per rank")
    return what in carried


def _staged(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


# ---------------------------------------------------------------------------
# Thin wrappers: every sharded site calls these
# ---------------------------------------------------------------------------

def _size(mesh, axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _all_reduce(x, mesh, axes, site, op="sum"):
    _route(x, mesh, "all_reduce")
    n = _size(mesh, axes)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=mesh.group(axes))
    meter(mesh).add("+".join(axes), site, 2 * (n - 1) / n * _nbytes(x))
    return out


def _all_gather(x, mesh, axes, dim, site):
    _route(x, mesh, "all_gather")
    n = _size(mesh, axes)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=mesh.group(axes))
    meter(mesh).add("+".join(axes), site, (n - 1) * _nbytes(x))
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x, mesh, axes, dim, site):
    _route(x, mesh, "reduce_scatter")
    n = _size(mesh, axes)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=mesh.group(axes))
    meter(mesh).add("+".join(axes), site, (n - 1) / n * _nbytes(x))
    return out.movedim(0, dim).contiguous()


# Under autograd each collective is a ``torch.autograd.Function`` whose
# backward is its transpose, run on the same line of ranks and metered at
# the site's name + ".grad". Every rank differentiates its own share of
# the objective (the sum of the shares over the ranks is the loss): the
# gradient of a replicated tensor is then this rank's part of the whole,
# and the transposes are exact: all-reduce <-> all-reduce, all-gather <->
# reduce-scatter, a local slice <-> autograd's own zero-padding. Megatron's
# f and g pair (``copy_to``, ``reduce_from``) carry values that every rank
# computes identically: their backward sums the ranks' parts (f) or takes
# the one it is handed (g).

def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, site, grad_op):
        ctx.args = (mesh, axes, site + ".grad", grad_op)
        return _all_reduce(x, mesh, axes, site)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, site, grad_op = ctx.args
        if grad_op == "sum":
            g = _all_reduce(g, mesh, axes, site)
        return g, None, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, site):
        ctx.args = (mesh, axes, site + ".grad")
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, site = ctx.args
        return _all_reduce(g, mesh, axes, site), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, site):
        ctx.args = (mesh, axes, dim, site + ".grad")
        return _all_gather(x, mesh, axes, dim, site)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, site):
        ctx.args = (mesh, axes, dim, site + ".grad")
        return _reduce_scatter(x, mesh, axes, dim, site)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None, None


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str],
               site: str = "", op: str = "sum") -> torch.Tensor:
    """Sum (``op="max"``: maximum, no gradient) of x over the ranks of
    this rank's line along ``axes`` (a new tensor). Its gradient is the
    all-reduced gradient."""
    axes = _key(mesh, axes)
    if _size(mesh, axes) == 1:
        return x
    if _grad(x):
        if op != "sum":
            raise ValueError(f"all_reduce: op={op!r} has no gradient")
        return _AllReduce.apply(x, mesh, axes, site, "sum")
    return _all_reduce(x, mesh, axes, site, op)


def reduce_from(x: torch.Tensor, mesh, axes: Sequence[str],
                site: str = "") -> torch.Tensor:
    """Megatron's g: the sum over ``axes`` of parts that each rank
    computed from its own share, consumed identically on every rank (a
    loss's statistics); the backward hands each part the gradient of the
    sum unchanged, so the value is counted once, not once per rank."""
    axes = _key(mesh, axes)
    if _size(mesh, axes) == 1:
        return x
    if _grad(x):
        return _AllReduce.apply(x, mesh, axes, site, "identity")
    return _all_reduce(x, mesh, axes, site)


def copy_to(x: torch.Tensor, mesh, axes: Sequence[str],
            site: str = "") -> torch.Tensor:
    """Megatron's f: x (the same on every rank of ``axes``) unchanged; the
    backward all-reduces the ranks' partial gradients over ``axes``, so
    every rank holds the whole gradient of its replica."""
    axes = _key(mesh, axes)
    if _size(mesh, axes) == 1 or not _grad(x):
        return x
    return _CopyTo.apply(x, mesh, axes, site)


def all_gather(x: torch.Tensor, mesh, axes: Sequence[str], dim: int = 0,
               site: str = "") -> torch.Tensor:
    """Concatenation along ``dim`` of every rank's x on this rank's line
    along ``axes``, in index order. Its gradient is reduce-scattered."""
    axes = _key(mesh, axes)
    if _size(mesh, axes) == 1:
        return x
    if _grad(x):
        return _AllGather.apply(x, mesh, axes, dim, site)
    return _all_gather(x, mesh, axes, dim, site)


def reduce_scatter(x: torch.Tensor, mesh, axes: Sequence[str],
                   dim: int = 0, site: str = "") -> torch.Tensor:
    """This rank's 1/n block along ``dim`` of the sum of x over this rank's
    line along ``axes`` (x.shape[dim] divisible by n). Its gradient is
    all-gathered."""
    axes = _key(mesh, axes)
    if _size(mesh, axes) == 1:
        return x
    if _grad(x):
        return _ReduceScatter.apply(x, mesh, axes, dim, site)
    return _reduce_scatter(x, mesh, axes, dim, site)


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]], mesh,
             axis_key: str, site: str = "") -> None:
    """Point-to-point: every (tensor, global rank) of ``sends`` is sent and
    every (buffer, global rank) of ``recvs`` received into, all posted
    together (the peer posts the matching operations in the same order).
    Staged through pinned host memory where the backend cannot send the
    device's tensors."""
    t = (list(sends) + list(recvs))[0][0]
    direct = _route(t, mesh, "send_recv")
    ops, back = [], []
    for x, dst in sends:
        ops.append(dist.P2POp(dist.isend, x.contiguous() if direct
                              else _staged(x), dst))
        meter(mesh).add(axis_key, site, _nbytes(x))
    for buf, src in recvs:
        r = buf if direct else torch.empty(buf.shape, dtype=buf.dtype,
                                           pin_memory=True)
        ops.append(dist.P2POp(dist.irecv, r, src))
        back.append((buf, r))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if not direct:
        for buf, r in back:
            buf.copy_(r)


# ---------------------------------------------------------------------------
# The reference's collectives
# ---------------------------------------------------------------------------

def hierarchical_psum(x: torch.Tensor, mesh, fast_axis: str, slow_axis: str,
                      scatter_dim: int = 0, site: str = "") -> torch.Tensor:
    """Sum over (fast x slow) with the slow axis carrying 1/|fast| of the
    bytes: reduce-scatter over fast, all-reduce over slow, all-gather over
    fast. A ``scatter_dim`` that does not divide falls back to the flat
    sum, as in the reference."""
    fast = mesh.shape[fast_axis]
    if x.shape[scatter_dim] % fast:
        return all_reduce(x, mesh, (fast_axis, slow_axis), site)
    shard = reduce_scatter(x, mesh, (fast_axis,), scatter_dim, site)
    shard = all_reduce(shard, mesh, (slow_axis,), site)
    return all_gather(shard, mesh, (fast_axis,), scatter_dim, site)


def hierarchical_pmean(x: torch.Tensor, mesh, fast_axis: str,
                       slow_axis: str, scatter_dim: int = 0,
                       site: str = "") -> torch.Tensor:
    total = mesh.shape[fast_axis] * mesh.shape[slow_axis]
    return hierarchical_psum(x, mesh, fast_axis, slow_axis, scatter_dim,
                             site) / total


def ring_all_gather(x: torch.Tensor, mesh, axis: str, concat_dim: int = 0,
                    site: str = "") -> torch.Tensor:
    """All-gather along ``axis`` as an explicit ring of n-1 send/recv
    steps (each rank passes what it last received to its successor), the
    pieces concatenated in index order: equal to ``all_gather``."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    ranks = mesh.group_ranks(axis)
    me = mesh.index(axis)
    nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
    pieces = {me: x.contiguous()}
    cur = pieces[me]
    for step in range(1, n):
        got = torch.empty_like(cur)
        exchange([(cur, nxt)], [(got, prv)], mesh, axis, site)
        pieces[(me - step) % n] = cur = got
    return torch.cat([pieces[i] for i in range(n)], dim=concat_dim)


def grad_sync(grads, mesh, dp_axes: Sequence[str],
              pod_axis: Optional[str] = None, site: str = "grad_sync",
              mean: bool = True):
    """Gradient mean over the data-parallel axes (``mean=False``: their
    sum, as the train step takes it: each rank's gradient is its part of
    the whole): hierarchical (fast ``dp_axes[0]``, slow ``pod_axis``) when
    both exist, else flat. ``grads``: a nested dict/list of tensors;
    returns the same structure."""
    from repro_torch.tree import tree_map
    axes = _key(mesh, tuple(dp_axes) + ((pod_axis,) if pod_axis else ()))
    total = _size(mesh, axes)

    def one(g):
        if pod_axis is None or not dp_axes:
            s = all_reduce(g, mesh, axes, site)
        else:
            s = hierarchical_psum(g, mesh, dp_axes[0], pod_axis, 0, site)
        return s / total if mean else s
    return tree_map(one, grads)


# ---------------------------------------------------------------------------
# The control group (CPU tensors, counted apart)
# ---------------------------------------------------------------------------

def control_broadcast(x: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """``x`` (a CPU tensor) from global rank ``src`` to every rank."""
    if mesh.size == 1:
        return x
    out = x.contiguous().clone()
    dist.broadcast(out, src, group=mesh.control)
    m = meter(mesh)
    m.control_calls += 1
    m.control_bytes += _nbytes(x)
    return out


def control_all_gather(x: torch.Tensor, mesh, axes: Sequence[str]
                       ) -> torch.Tensor:
    """Every rank's CPU ``x`` stacked (dim 0, in index order along
    ``axes``) on every rank: a gloo all-gather over the control group,
    the ranks outside this rank's line along ``axes`` dropped."""
    if mesh.size == 1:
        return x[None]
    x = x.contiguous().reshape(-1)
    out = torch.empty((mesh.size * x.numel(),), dtype=x.dtype)
    dist.all_gather_into_tensor(out, x, group=mesh.control)
    out = out.view(mesh.size, -1)
    m = meter(mesh)
    m.control_calls += 1
    m.control_bytes += _nbytes(x) * (mesh.size - 1)
    return out[list(mesh.group_ranks(axes))] if _key(mesh, axes) else \
        out[[mesh.rank]]


def control_exchange(sends: Sequence[Tuple[torch.Tensor, int]],
                     recvs: Sequence[Tuple[torch.Tensor, int]], mesh
                     ) -> None:
    """Point-to-point over the control group: every (CPU tensor, global
    rank) of ``sends`` is sent and every (CPU buffer, global rank) of
    ``recvs`` received into, all posted together (the peer posts the
    matching operations in the same order)."""
    ops = [dist.P2POp(dist.isend, x.contiguous(), dst, group=mesh.control)
           for x, dst in sends]
    ops += [dist.P2POp(dist.irecv, buf, src, group=mesh.control)
            for buf, src in recvs]
    if not ops:
        return
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    m = meter(mesh)
    m.control_calls += 1
    m.control_bytes += sum(_nbytes(x) for x, _ in sends)
