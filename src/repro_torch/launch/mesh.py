"""A mesh of ``torch.distributed`` ranks with named axes: the port of
``repro.launch.mesh``.

SPMD, one process per rank, as ``torchrun`` deploys PyTorch: every rank
builds the same ``Mesh`` and runs the same program on its own shard. Ranks
are laid out row-major over the axes, so on a ``("data", "model")`` mesh of
shape (D, M) rank ``d * M + m`` sits at data row d and model column m.
"model" is the fast tensor-parallel axis, "data" the batch axis, "pod" the
outermost (slow) axis of a three-axis mesh.

The mesh holds one process group per axis line for every non-empty set of
axes (the ranks that differ only along those axes), built with
``dist.new_group`` in the same order on every rank, and a ``control`` group
on ``gloo`` over every rank for CPU tensors: the serving engine's
lock-step decisions and gathered host results travel there, apart from the
device's own collectives.

``launch`` (and ``spawn``, which waits) starts the ranks of a mesh with
``torch.multiprocessing`` and joins them through a ``FileStore`` in a fresh
temporary directory (no TCP port is ever fixed); a rendezvous whose
process groups fail to connect is started once more from a fresh store.
Each rank's device is explicit: ``cpu``, one card per rank
(``cuda:<rank>``, ``nccl``), or, asked for with ``share_device``,
every rank on ``cuda:0`` over ``gloo`` (a single card: NCCL refuses two
ranks on one device).
"""
from __future__ import annotations

import datetime
import faulthandler
import itertools
import os
import pickle
import shutil
import signal
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, FrozenSet, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


class Mesh:
    """This process's view of a mesh of ranks.

    ``shape``: axis name -> size (ordered as the axes); ``rank``: the global
    rank; ``coords``: axis name -> this rank's index along it; ``device``:
    the rank's device; ``control``: the gloo group of every rank. Built
    after ``dist.init_process_group`` (world size = the mesh's size)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device: torch.device, control_backend: str = "gloo"):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(s) for s in shape)))
        self.size = int(np.prod(shape))
        world = dist.get_world_size()
        if world != self.size:
            raise RuntimeError(f"mesh {tuple(shape)} needs {self.size} ranks, "
                               f"the process group has {world}")
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        grid = np.arange(self.size).reshape(tuple(shape))
        self.coords = {a: int(i) for a, i in zip(
            axes, np.unravel_index(self.rank, tuple(shape)))}
        self._groups: Dict[FrozenSet[str], Any] = {}
        self._ranks: Dict[FrozenSet[str], Tuple[int, ...]] = {}
        # every non-empty subset of axes, in one order on every rank
        for n in range(1, len(axes) + 1):
            for sub in itertools.combinations(range(len(axes)), n):
                keep = [i for i in range(len(axes)) if i not in sub]
                lines = np.moveaxis(grid, keep, list(range(len(keep))))
                lines = lines.reshape(-1, int(np.prod([shape[i]
                                                       for i in sub])))
                key = frozenset(axes[i] for i in sub)
                for line in lines:
                    ranks = tuple(int(r) for r in line)
                    g = dist.new_group(list(ranks)) if len(ranks) < world \
                        else dist.group.WORLD
                    if self.rank in ranks:
                        self._groups[key], self._ranks[key] = g, ranks
        self.control = dist.group.WORLD if self.backend == control_backend \
            else dist.new_group(list(range(world)), backend=control_backend)

    @property
    def devices_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape.values())

    def group(self, axes) -> Any:
        """The process group of this rank's line along ``axes`` (a name or
        a tuple of names)."""
        return self._groups[frozenset((axes,) if isinstance(axes, str)
                                      else axes)]

    def group_ranks(self, axes) -> Tuple[int, ...]:
        """Global ranks of this rank's line along ``axes``, in the order of
        their index along those axes (row-major over the mesh's axes)."""
        return self._ranks[frozenset((axes,) if isinstance(axes, str)
                                     else axes)]

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major in mesh order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in self.axis_names:
            if a in axes:
                i = i * self.shape[a] + self.coords[a]
        return i

    def rank_at(self, **coords) -> int:
        """Global rank at the given coordinates (the others: this rank's)."""
        c = dict(self.coords, **coords)
        return int(np.ravel_multi_index(
            tuple(c[a] for a in self.axis_names), self.devices_shape))

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device})")


class SubMesh(Mesh):
    """The rows [r0, r1) of the first axis of a mesh, as a mesh of their
    own (the reference's ``split_mesh`` halves): its own axis lines and
    groups (built collectively by ``submesh``), the parent's device,
    backend, control group and byte meter."""

    def __init__(self, parent: Mesh, r0: int, r1: int, groups, ranks):
        self.parent = parent
        self.axis_names = parent.axis_names
        first = self.axis_names[0]
        self.shape = dict(parent.shape, **{first: r1 - r0})
        self.size = int(np.prod(list(self.shape.values())))
        self.rank = parent.rank
        self.device = parent.device
        self.backend = parent.backend
        self.control = parent.control
        self.coords = dict(parent.coords,
                           **{first: parent.coords[first] - r0})
        self._groups, self._ranks = groups, ranks
        self.row0 = r0

    @property
    def meter(self):
        from repro_torch.core.collectives import meter
        return meter(self.parent)

    def rank_at(self, **coords) -> int:
        first = self.axis_names[0]
        c = dict(self.coords, **coords)
        c[first] += self.row0
        return int(np.ravel_multi_index(
            tuple(c[a] for a in self.axis_names), self.parent.devices_shape))


def submesh(mesh: Mesh, r0: int, r1: int) -> Optional[SubMesh]:
    """Collective (every rank of ``mesh`` calls it, in one order): the
    rows [r0, r1) of ``mesh``'s first axis as a ``SubMesh`` for the ranks
    inside them, None for the others."""
    shape = mesh.devices_shape
    axes = mesh.axis_names
    grid = np.arange(mesh.size).reshape(shape)[r0:r1]
    sub_shape = grid.shape
    groups, ranks = {}, {}
    for n in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), n):
            keep = [i for i in range(len(axes)) if i not in sub]
            lines = np.moveaxis(grid, keep, list(range(len(keep))))
            lines = lines.reshape(-1, int(np.prod([sub_shape[i]
                                                   for i in sub])))
            key = frozenset(axes[i] for i in sub)
            for line in lines:
                rs = tuple(int(r) for r in line)
                g = dist.new_group(list(rs))
                if mesh.rank in rs:
                    groups[key], ranks[key] = g, rs
    if not r0 <= mesh.coords[axes[0]] < r1:
        return None
    return SubMesh(mesh, r0, r1, groups, ranks)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device: Optional[torch.device] = None) -> Mesh:
    """A small mesh over the initialised process group (world size =
    prod(shape)); ``device``: this rank's (default: the CPU)."""
    return Mesh(shape, axes, torch.device("cpu") if device is None
                else device)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[torch.device] = None) -> Mesh:
    """(16, 16) ("data", "model") or, multi-pod, (2, 16, 16) ("pod",
    "data", "model"). Checks only that the process group has that many
    ranks, as the reference checks its device count."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have}: start one "
            "process per rank (torchrun, or repro_torch.launch.mesh.spawn)")
    return Mesh(shape, axes, torch.device("cpu") if device is None
                else device)


# ---------------------------------------------------------------------------
# Launching the ranks of a mesh
# ---------------------------------------------------------------------------

def rank_device(rank: int, device: str, share_device: bool) -> torch.device:
    """``cpu``; ``cuda:0`` for every rank when ``share_device``; else
    ``cuda:<rank>``."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    return torch.device("cuda", 0 if share_device else rank)


def backend_for(device: str, share_device: bool) -> str:
    """gloo for the CPU and for ranks sharing one card; nccl for one card
    per rank."""
    return "nccl" if device == "cuda" and not share_device else "gloo"


def _rank_main(rank, fn, shape, axes, device, share_device, tmp, threads,
               timeout_s):
    out = os.path.join(tmp, f"rank{rank}.pkl")
    status = "init_error"
    # SIGUSR1 writes every thread's Python stack here (the launcher sends
    # it when the run reaches its wall-clock ceiling, then kills the rank)
    stacks = open(os.path.join(tmp, f"stack{rank}.txt"), "w")
    faulthandler.register(signal.SIGUSR1, file=stacks, all_threads=True)
    try:
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(rank, device, share_device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        world = int(np.prod(shape))
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(
            backend_for(device, share_device), store=store, rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = Mesh(shape, axes, dev)
            open(os.path.join(tmp, f"ready{rank}"), "w").close()
            status = "error"
            res = ("ok", fn(mesh, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        res = (status, traceback.format_exc())
    with open(out + ".part", "wb") as f:
        pickle.dump(res, f)
    os.replace(out + ".part", out)


# seconds without progress (no rank used CPU time) after which a mesh
# whose ranks have not all joined their process groups counts as a failed
# rendezvous
INIT_S = 120.0
# the default wall-clock ceiling of one launch, from its start: six times
# the longest mesh test module's whole run alone (~100 s), and above any
# progress-based limit a launch can reach first
WALL_S = 600.0


def cpu_seconds(pids) -> float:
    """User + system CPU seconds of the processes ``pids`` (from
    ``/proc/<pid>/stat``; a process that has ended counts 0)."""
    ticks = 0
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            ticks += int(fields[11]) + int(fields[12])
        except (OSError, IndexError, ValueError):
            pass
    return ticks / os.sysconf("SC_CLK_TCK")


class RendezvousFailed(RuntimeError):
    """The ranks did not all join their process groups."""


class Launch:
    """The ranks of one ``launch``: ``join`` waits for them and returns
    their results in rank order. A rendezvous that fails (a rank whose
    process groups did not connect, or not within ``INIT_S``) is started
    once more from a fresh store, as an elastic agent restarts a failed
    rendezvous; a failure after every rank has joined is never retried,
    and the first rank that raises stops the others (as an elastic agent
    stops a job's workers when one fails)."""

    def __init__(self, start: Callable, shape, world: int,
                 timeout_s: float, wall_s: float = WALL_S):
        self.start, self.shape, self.world = start, tuple(shape), world
        self.timeout_s, self.wall_s = timeout_s, wall_s
        self.t_start = time.monotonic()
        self.ctx, self.tmp = start()

    def _kill(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
        shutil.rmtree(self.tmp, ignore_errors=True)

    def _stacks(self) -> dict:
        """Every live rank's Python stacks (all threads), asked for by
        SIGUSR1 (``faulthandler`` in the rank writes them to its file)."""
        alive = [(r, p) for r, p in enumerate(self.ctx.processes)
                 if p.is_alive()]
        for _, p in alive:
            try:
                os.kill(p.pid, signal.SIGUSR1)
            except OSError:
                pass
        time.sleep(1.0)
        out = {}
        for r, _ in alive:
            try:
                with open(os.path.join(self.tmp, f"stack{r}.txt")) as f:
                    out[r] = f.read() or "(no stack written)"
            except OSError:
                out[r] = "(no stack written)"
        return out

    def _failed(self, errors: dict) -> RuntimeError:
        return RuntimeError(f"mesh {self.shape}: rank(s) {sorted(errors)} "
                            "failed:\n" + "\n".join(
                                f"-- rank {r}:\n{errors[r]}"
                                for r in sorted(errors)))

    def _wait(self) -> list:
        # the limits count time in which no rank made progress (used CPU
        # time), not wall time: a machine loaded by other work slows the
        # ranks down without failing them, while a hung mesh still fails
        # (a collective that waits past the process groups' timeout
        # raises in its rank); ranks that keep busy and never finish are
        # stopped at the wall-clock ceiling ``wall_s`` from the launch
        pids = [p.pid for p in self.ctx.processes]
        cpu, t0 = cpu_seconds(pids), time.monotonic()
        ready = lambda: all(os.path.exists(  # noqa: E731
            os.path.join(self.tmp, f"ready{r}")) for r in range(self.world))
        results, errors, failed_at = {}, {}, None
        while True:
            finished = self.ctx.join(timeout=1)
            for r in range(self.world):
                path = os.path.join(self.tmp, f"rank{r}.pkl")
                if r in results or r in errors or not os.path.exists(path):
                    continue
                with open(path, "rb") as f:
                    status, val = pickle.load(f)
                if status == "init_error":
                    raise RendezvousFailed(val)
                if status == "ok":
                    results[r] = val
                else:
                    errors[r] = val
                    failed_at = failed_at or time.monotonic()
            if finished:
                break
            # one rank failed: the others fail in their next collective
            # or wait in it until the process groups time out; their
            # errors are collected for a moment, then the mesh is stopped
            if failed_at is not None and time.monotonic() - failed_at > 5:
                raise self._failed(errors)
            if time.monotonic() - self.t_start > self.wall_s:
                stacks = self._stacks()
                raise TimeoutError(
                    f"mesh {self.shape}: the ranks ran past the wall-clock "
                    f"ceiling of {self.wall_s:.0f} s and were stopped; "
                    "their stacks:\n" + "\n".join(
                        f"-- rank {r}:\n{stacks[r]}" for r in sorted(stacks))
                    + "".join(f"\n-- rank {r} (failed):\n{errors[r]}"
                              for r in sorted(errors)))
            now = cpu_seconds(pids)
            if now > cpu + 0.05:
                cpu, t0 = now, time.monotonic()
            idle = time.monotonic() - t0
            if idle > INIT_S and not ready():
                raise RendezvousFailed(
                    f"not every rank joined, and none made progress for "
                    f"{INIT_S:.0f} s")
            if idle > self.timeout_s:
                raise TimeoutError(
                    f"mesh {self.shape}: no rank made progress for "
                    f"{self.timeout_s:.0f} s")
        if errors:
            raise self._failed(errors)
        missing = [r for r in range(self.world) if r not in results]
        if missing:
            raise RuntimeError(f"mesh {self.shape}: rank(s) {missing} left "
                               "no result")
        return [results[r] for r in range(self.world)]

    def join(self) -> list:
        """Raises if a rank raised, died or outlived the timeout (its
        processes are killed)."""
        for attempt in range(2):
            try:
                return self._wait()
            except RendezvousFailed as e:
                self._kill()
                if attempt:
                    raise RuntimeError(f"mesh {self.shape}: the ranks did "
                                       f"not connect twice:\n{e}") from None
                self.ctx, self.tmp = self.start()
            except mp.ProcessExitedException as e:
                self._kill()
                raise RuntimeError(f"mesh {self.shape}: a rank died: "
                                   f"{e}") from None
            except BaseException:
                self._kill()
                raise
            finally:
                if self.ctx is not None and not any(
                        p.is_alive() for p in self.ctx.processes):
                    shutil.rmtree(self.tmp, ignore_errors=True)


def launch(fn: Callable, shape: Sequence[int],
           axes: Sequence[str] = ("data", "model"), args: Tuple = (), *,
           device: str = "cpu", share_device: bool = False,
           threads: int = 1, timeout_s: float = 300.0,
           wall_s: float = WALL_S) -> Launch:
    """Start ``fn(mesh, *args)`` on every rank of a ``shape`` mesh, one
    spawned process each (``fn`` importable: a module-level function), and
    return at once; ``Launch.join`` collects the results (pickled through
    files). Each rank runs ``threads`` intra-op threads. The process
    groups time out after ``timeout_s``, so a hung collective fails
    instead of hanging, and ``join`` gives up after ``timeout_s`` in
    which no rank made progress (used CPU time); the ranks must all have
    joined before ``INIT_S`` passes without progress. Whatever the ranks
    do, ``join`` stops them ``wall_s`` seconds after the launch (the
    wall-clock ceiling) and raises with every rank's Python stacks."""
    world = int(np.prod(shape))
    if device == "cuda" and not share_device and \
            torch.cuda.device_count() < world:
        raise RuntimeError(
            f"{world} ranks need {world} cards for one card per rank; this "
            f"machine has {torch.cuda.device_count()}: pass "
            "share_device=True to put every rank on cuda:0 over gloo")

    def start():
        tmp = tempfile.mkdtemp(prefix="mesh-")
        # the arguments go through a file: through the spawn pipe a large
        # pickle would block each start until its child had imported torch
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f)
        ctx = mp.start_processes(
            _rank_main, args=(fn, tuple(shape), tuple(axes), device,
                              share_device, tmp, threads, timeout_s),
            nprocs=world, join=False, start_method="spawn")
        return ctx, tmp
    return Launch(start, shape, world, timeout_s, wall_s)


def spawn(fn: Callable, shape: Sequence[int],
          axes: Sequence[str] = ("data", "model"), args: Tuple = (),
          **kw) -> list:
    """``launch(...).join()``: the ranks' results in rank order."""
    return launch(fn, shape, axes, args, **kw).join()
