"""Which collectives the ``gloo`` backend carries on CUDA tensors.

    python3 tools/gloo_cuda_probe.py [--world 2]

For each collective it spawns ``--world`` fresh ranks on one card
(``cuda:0``; gloo, a ``FileStore`` rendezvous in a temporary directory),
since a collective gloo cannot carry may abort its process rather than
raise. It calls each collective the port's
``core/collectives.py`` uses with CUDA tensors: ``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``broadcast``,
``batch_isend_irecv`` (send/recv pairs) and ``all_to_all_single``. Each
result is held against the sum, concatenation or slice it must give. Rank 0
prints one line per collective (``ok``, ``wrong`` or the error's first
line, or ``aborted`` when the ranks died) and a last JSON line with the
same table, so the collectives module's
table of staged and straight-through calls can be checked against the
card's torch. Needs a GPU; a hung collective fails the probe through the
process group's timeout.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _probe(rank: int, world: int, store_path: str, out_path: str,
           which: str):
    torch.cuda.set_device(0)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    n = 8 * world
    base = torch.arange(n, dtype=torch.float32, device=dev)

    def x_of(r):
        return base + 100.0 * r

    want_sum = sum(x_of(r) for r in range(world))

    def all_reduce():
        x = x_of(rank).clone()
        dist.all_reduce(x)
        return torch.equal(x, want_sum)

    def all_gather_into_tensor():
        out = torch.empty(n * world, device=dev)
        dist.all_gather_into_tensor(out, x_of(rank))
        return torch.equal(out, torch.cat([x_of(r) for r in range(world)]))

    def reduce_scatter_tensor():
        out = torch.empty(n // world, device=dev)
        dist.reduce_scatter_tensor(out, x_of(rank).clone())
        k = n // world
        return torch.equal(out, want_sum[rank * k:(rank + 1) * k])

    def broadcast():
        x = x_of(rank).clone()
        dist.broadcast(x, 0)
        return torch.equal(x, x_of(0))

    def batch_isend_irecv():
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        got = torch.empty(n, device=dev)
        ops = [dist.P2POp(dist.isend, x_of(rank).clone(), nxt),
               dist.P2POp(dist.irecv, got, prv)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return torch.equal(got, x_of(prv))

    def all_to_all_single():
        out = torch.empty(n, device=dev)
        dist.all_to_all_single(out, x_of(rank).clone())
        k = n // world
        want = torch.cat([x_of(r)[rank * k:(rank + 1) * k]
                          for r in range(world)])
        return torch.equal(out, want)

    fn = {f.__name__: f for f in (
        all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
        broadcast, batch_isend_irecv, all_to_all_single)}[which]
    try:
        ok = fn()
        torch.cuda.synchronize()
        res = "ok" if ok else "wrong"
    except Exception as e:              # the table records the refusal
        res = type(e).__name__ + ": " + str(e).strip().splitlines()[0][:160]
    if rank == 0:
        with open(out_path, "w") as f:
            f.write(res)
    dist.destroy_process_group()


COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "broadcast", "batch_isend_irecv",
               "all_to_all_single")


def probe_one(which: str, world: int) -> str:
    """One collective in a fresh world of ``world`` ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "res")
        ctx = mp.start_processes(
            _probe, args=(world, os.path.join(tmp, "store"), out, which),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + 120
        try:
            while not ctx.join(timeout=2) and time.monotonic() < deadline:
                pass
        except Exception:               # a rank died: its peer fails too
            pass
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        if not os.path.exists(out):
            return "aborted"
        with open(out) as f:
            return f.read()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    table = {which: probe_one(which, args.world) for which in COLLECTIVES}
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{args.world} gloo ranks on {torch.cuda.get_device_name(0)}")
    for name, res in table.items():
        print(f"  {name}: {res}")
    print(json.dumps({"gloo_cuda": table, "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
