"""Serving engine: the port of ``repro.runtime.serving``, in
continuous-batching and drain mode, with the reference's failure model and
its two executor backends (colocated and weight–attention).

- the decode batch is a fixed set of SLOTS; a queued request is admitted
  into any free slot mid-serve,
- every row carries its own cursor (``positions``) and an ``active`` mask,
  so retired slots neither write KV nor pollute the argmax,
- macro-step decode (``block_size`` = T > 1) runs T greedy micro-steps per
  host round-trip with on-device halting (``ModelAPI.decode_block``),
- admission is monolithic (one full-width prefill + slot write) or the
  chunked-prefill lane (``prefill_chunk`` = C > 0: at most one fixed-(1,C)
  chunk per block boundary, cursors at the TRUE prompt length),
- length-aware KV walking: each macro-step uses the smallest KV bucket
  covering every live cursor + T (``kv_bucket_chunk``),
- split-KV decode (``a_shards`` = n > 1): every bucket is read as n equal
  sequence shards whose partial softmax statistics are LSE-merged,
- ``mode="drain"``: the drain-then-refill baseline. The whole batch is
  prefilled at once and decodes with one shared cursor until every slot
  has finished; only then are queued requests admitted,
- tiered KV (a config with ``hot_window`` > 0): each slot keeps its most
  recent tokens exact in a hot ring and every position quantized in a cold
  tier; the hot-to-cold boundary advances inside the step programs, and
  monolithic admission runs the full-width chunk program (``serve_admit``)
  that stages both tiers. The host-side ``KVArbiter`` prices the live
  bytes off the scheduler's cursors and, with ``kv_budget_bytes``,
  preempts victims while they exceed the budget,
- recurrent families: an O(1) state (the SSM) or a ring KV cache beside it
  (the hybrid) has no KV extent, so admission sets no length bound, the
  block programs have no buckets, and split-KV, preemption and the WA
  backend refuse; ``mode="auto"`` serves a family without slotted decode
  or admission (the hybrid) in drain mode,
- the VLM serves text-only, as the reference engine does (its admission
  passes no vision embeddings): continuous with monolithic admission
  (the family has no chunk lane) on the colocated backend; the enc-dec
  family is refused at construction (the engine's prefill has no frames
  input).

Serving under pressure (the failure model): requests carry a ``priority``
and TTFT/TPOT deadlines; admission drains the queue in priority order, a
bounded queue (``max_queue``) sheds the lowest-priority work as structured
rejections, and queued requests past their TTFT deadline are shed as
deadline misses. With ``preemptible=True`` a block boundary may swap a
victim slot's stored KV out to the host (``serve_swap_out``, int8 scales
included) and restore it later with its cursors (``serve_swap_in``), token
for token as if never preempted. Every program dispatch retries on
``DispatchError`` with backoff, counts watchdog overruns, and demotes a
request whose dispatch keeps failing to a structured rejection (quarantining
the slot whose bytes are suspect); any other exception propagates. Every
request ends completed, rejected or deadline_missed.

The host-side ``SlotScheduler`` decides what runs at each block boundary;
the ``ExecutorBackend`` owns the slot caches and the registered step
programs; ``ServingEngine`` is the boundary loop between them and counts
its one host sync per decode round (``host_syncs``). ``backend="wa"``
serves every continuous-mode program through ``core/wa.py``: the weight
ops on the caller's CUDA stream, the KV side on a stream of its own, with
``overlap`` = D > 1 pipelining D micro-batches across the two.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.collectives import (control_all_gather,
                                          control_broadcast,
                                          control_exchange, meter)
from repro_torch.core.pipeline import wa_schedule_occupancy
from repro_torch.core.wa import (WADisaggregated, micro_batch_slices,
                                 routing_bytes)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kv.cache import (KVCache, empty_slot_image, export_slot_kv,
                                  import_slot_kv)
from repro_torch.models.attention import bucket_for, kv_buckets
from repro_torch.models.common import dtype_of
from repro_torch.models.registry import DECODE_SLACK, ModelAPI, build_model
from repro_torch.models.sharding import NULL_CTX, ShardingCtx
from repro_torch.runtime.static_runtime import DispatchError, StaticRuntime


class RequestRejected(ValueError):
    """Enqueue-time rejection of an unrepresentable request, with the
    request id, the offending length and the limit as fields."""

    def __init__(self, rid: int, reason: str, *, length=None, limit=None,
                 limit_name: str = ""):
        self.rid, self.reason = rid, reason
        self.length, self.limit, self.limit_name = length, limit, limit_name
        super().__init__(f"request {rid}: {reason}")


class DispatchFailure(RuntimeError):
    """A program dispatch kept raising ``DispatchError`` past the bounded
    retry budget. The boundary loop demotes it to a structured rejection
    of the responsible request (and quarantines the slot whose cache bytes
    are suspect), never a hung engine."""

    def __init__(self, name: str, attempts: int, cause: Exception):
        self.name, self.attempts, self.cause = name, attempts, cause
        super().__init__(f"dispatch of {name!r} failed after {attempts} "
                         f"attempt(s): {cause}")


@dataclass
class SwapState:
    """Host-side image of a preempted slot: the full-extent STORED bytes
    (the ``export_slot_kv`` tuple on the CPU, int8 values and scales
    verbatim; on a mesh a ``RankImage``, this rank's part) plus the cursor
    triple that makes the restore token-exact. The true KV length travels
    here, not in the buffer."""
    saved: Any                       # export_slot_kv tuple, host tensors
    kv_len: int                      # TRUE length: the cursor at swap-out
    last_tok: int                    # last emitted token (KV not written)
    remaining: int                   # decode budget left


@dataclass
class RankImage:
    """A swapped-out slot on a mesh: the data row whose ranks hold it and
    this rank's part of its ``export_slot_kv`` tuple on the host (its KV
    heads or its block of positions; None on the ranks of other rows).
    Nothing is gathered: a restore into another row moves each part to
    the rank of that row at the same coordinates on the other axes."""
    row: int
    parts: Optional[Tuple]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (L,) int32 — TRUE length
    max_new_tokens: int
    arrival_step: int = 0               # decode step at which it is queued
    eos_id: int = -1                    # stop id (< 0 -> budget only)
    generated: List[int] = field(default_factory=list)
    t_enqueue: float = 0.0
    t_admitted: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    admit_step: int = -1
    t_last_emit: float = 0.0
    max_gap: float = 0.0
    priority: int = 0                   # higher wins admission and
                                        # survives preemption/shedding
    ttft_deadline_ms: float = 0.0       # 0: none; queued past it: shed
    tpot_deadline_ms: float = 0.0       # target (recorded, never sheds)
    status: str = "pending"             # pending/queued/active, then
                                        # completed|rejected|deadline_missed
    reject_reason: Optional[str] = None
    preemptions: int = 0                # times swapped out of a slot
    swap: Optional[SwapState] = None    # host KV image while preempted
    kv_base: int = 0                    # cursor at start_decode

    @property
    def done(self) -> bool:
        if self.eos_id >= 0 and self.generated \
                and self.generated[-1] == self.eos_id:
            return True
        return len(self.generated) >= self.max_new_tokens

    def note_emit(self, now: float):
        if self.t_last_emit > 0.0:
            self.max_gap = max(self.max_gap, now - self.t_last_emit)
        self.t_last_emit = now

    def metrics(self) -> Dict[str, Any]:
        n = len(self.generated)
        ttft = max(0.0, self.t_first_token - self.t_enqueue) * 1e3
        tpot = ((self.t_done - self.t_first_token) / (n - 1) * 1e3
                if n > 1 else 0.0)
        return {
            "rid": self.rid,
            "tokens": n,
            "prompt_tokens": int(len(self.prompt)),
            "arrival_step": self.arrival_step,
            "admit_step": self.admit_step,
            "queue_delay_ms": max(0.0, self.t_admitted - self.t_enqueue) * 1e3,
            "ttft_ms": ttft,
            "tpot_ms": tpot,
            "max_gap_ms": self.max_gap * 1e3,
            "priority": self.priority,
            "status": self.status,
            "preemptions": self.preemptions,
            "ttft_deadline_met": bool(self.ttft_deadline_ms <= 0
                                      or ttft <= self.ttft_deadline_ms),
            "tpot_deadline_met": bool(self.tpot_deadline_ms <= 0
                                      or tpot <= self.tpot_deadline_ms),
        }


def pad_row(prompt: np.ndarray, width: int) -> np.ndarray:
    """Zero-pad a prompt (slice) up to a static width; never truncates."""
    if len(prompt) > width:
        raise ValueError(f"prompt slice of {len(prompt)} exceeds width "
                         f"{width}")
    row = np.zeros((width,), np.int32)
    row[:len(prompt)] = prompt
    return row


# ---------------------------------------------------------------------------
# SlotScheduler — the HOST half
# ---------------------------------------------------------------------------

class SlotScheduler:
    """Slot occupancy, arrival pump, per-slot cursors/halt operands and the
    chunk-lane bookkeeping. Host state only: it never touches a tensor."""

    FREE, PREFILL, DECODE = "free", "prefill", "decode"

    def __init__(self, n_slots: int, requests: List[Request],
                 queue: List[Request]):
        self.n = n_slots
        self.pending = sorted(requests, key=lambda r: r.arrival_step)
        self.queue = queue
        self.req: List[Optional[Request]] = [None] * n_slots
        self.phase = [self.FREE] * n_slots
        self.filled = [0] * n_slots
        self.prefill_fifo: List[int] = []
        self.positions = np.zeros((n_slots,), np.int32)
        self.last_tok = np.zeros((n_slots,), np.int32)
        self.remaining = np.zeros((n_slots,), np.int32)
        self.eos = np.full((n_slots,), -1, np.int32)
        self.quarantined: set = set()            # poisoned, never reused

    def work_remaining(self) -> bool:
        return bool(self.pending or self.queue
                    or any(p != self.FREE for p in self.phase))

    def pump(self, step: int):
        """Requests whose arrival_step has come move to the queue (stamped
        here unless ``submit()`` already stamped them)."""
        while self.pending and self.pending[0].arrival_step <= step:
            r = self.pending.pop(0)
            if not r.t_enqueue:
                r.t_enqueue = time.monotonic()
            r.status = "queued"
            self.queue.append(r)

    def occupied(self) -> bool:
        return any(p != self.FREE for p in self.phase)

    def decode_active(self) -> np.ndarray:
        return np.array([p == self.DECODE for p in self.phase])

    def micro_batch_view(self, depth: int, active=None):
        """Per-micro-batch (slot indices, active-mask rows) under overlap
        depth ``depth``, through ``core.wa.micro_batch_slices``: the row
        split the pipelined layer loop uses."""
        act = self.decode_active() if active is None else np.asarray(active)
        return [(list(range(sl.start, sl.stop)), act[sl])
                for sl in micro_batch_slices(self.n, depth)]

    def usable_free(self) -> Optional[int]:
        """Lowest-index FREE slot that is not quarantined, or None."""
        for i in range(self.n):
            if self.phase[i] == self.FREE and i not in self.quarantined:
                return i
        return None

    def usable_capacity(self) -> int:
        return self.n - len(self.quarantined)

    def pop_queue(self) -> Optional[Request]:
        """Highest-priority queued request; FIFO (enqueue stamp, then rid)
        within a priority class. A preempted request keeps its ORIGINAL
        enqueue stamp, so it re-admits ahead of later arrivals of its
        class."""
        if not self.queue:
            return None
        j = min(range(len(self.queue)),
                key=lambda j: (-self.queue[j].priority,
                               self.queue[j].t_enqueue, self.queue[j].rid))
        return self.queue.pop(j)

    def top_priority(self) -> Optional[int]:
        return max((r.priority for r in self.queue), default=None)

    def decode_slots(self) -> List[int]:
        return [i for i in range(self.n) if self.phase[i] == self.DECODE]

    def begin_prefill(self, slot: int, r: Request, step: int):
        r.t_admitted = time.monotonic()
        r.admit_step = step
        r.status = "active"
        self.req[slot] = r
        self.phase[slot] = self.PREFILL
        self.filled[slot] = 0
        self.prefill_fifo.append(slot)

    def next_chunk(self, chunk: int, kv_extent: Optional[int]
                   ) -> Optional[Tuple[int, Request, int, int]]:
        """(slot, request, start, n_valid) of the next fixed-(1,C) chunk, or
        None. A window that would overrun the KV extent shifts LEFT over
        already-written positions (recomputing them is bit-identical); a
        recurrent state (``kv_extent`` None) has no extent to overrun."""
        if not self.prefill_fifo:
            return None
        i = self.prefill_fifo[0]
        r = self.req[i]
        start = self.filled[i]
        if kv_extent is not None and start + chunk > kv_extent:
            start = kv_extent - chunk
        return i, r, start, min(chunk, len(r.prompt) - start)

    def chunk_done(self, slot: int, start: int, n_valid: int) -> bool:
        self.filled[slot] = start + n_valid
        if self.filled[slot] >= len(self.req[slot].prompt):
            self.prefill_fifo.pop(0)
            return True
        return False

    def start_decode(self, slot: int, cursor: int, first_tok: int):
        r = self.req[slot]
        r.kv_base = cursor
        self.phase[slot] = self.DECODE
        self.positions[slot] = cursor
        self.last_tok[slot] = first_tok
        self.remaining[slot] = r.max_new_tokens - 1
        self.eos[slot] = r.eos_id

    def preempt(self, slot: int) -> Request:
        """Release a DECODE slot whose KV the caller has already swapped
        out; the request goes back to the queue carrying its SwapState."""
        if self.phase[slot] != self.DECODE:
            raise RuntimeError(f"preempting slot {slot} in phase "
                               f"{self.phase[slot]}")
        r = self.req[slot]
        self.req[slot] = None
        self.phase[slot] = self.FREE
        r.status = "queued"
        self.queue.append(r)
        return r

    def resume_decode(self, slot: int, r: Request, state: SwapState):
        """Re-enter DECODE from a restored swap image: the cursors resume
        where the preemption cut them, and the next decode step appends
        ``last_tok``'s KV at ``kv_len`` as an uninterrupted serve would."""
        r.status = "active"
        self.req[slot] = r
        self.phase[slot] = self.DECODE
        self.positions[slot] = state.kv_len
        self.last_tok[slot] = state.last_tok
        self.remaining[slot] = state.remaining
        self.eos[slot] = r.eos_id

    def retire(self, slot: int):
        self.req[slot] = None
        self.phase[slot] = self.FREE
        if slot in self.prefill_fifo:
            self.prefill_fifo.remove(slot)

    def invariant_violations(self) -> List[str]:
        """Occupancy/cursor consistency at a block boundary: FREE iff no
        request, quarantined implies FREE, no rid in two slots, the prefill
        FIFO holds exactly PREFILL slots, and every DECODE slot's cursor and
        budget match its request's emission count."""
        bad: List[str] = []
        seen: Dict[int, int] = {}
        for i in range(self.n):
            r, ph = self.req[i], self.phase[i]
            if ph == self.FREE and r is not None:
                bad.append(f"slot {i}: FREE but holds rid {r.rid}")
            if ph != self.FREE and r is None:
                bad.append(f"slot {i}: {ph} with no request")
            if ph != self.FREE and i in self.quarantined:
                bad.append(f"slot {i}: quarantined but {ph}")
            if r is not None:
                if r.rid in seen:
                    bad.append(f"rid {r.rid} in slots {seen[r.rid]} and {i}")
                seen[r.rid] = i
            if ph == self.DECODE:
                want_pos = r.kv_base + len(r.generated) - 1
                if int(self.positions[i]) != want_pos:
                    bad.append(
                        f"slot {i} rid {r.rid}: cursor {self.positions[i]} "
                        f"!= kv_base {r.kv_base} + emitted "
                        f"{len(r.generated)} - 1")
                if int(self.remaining[i]) != r.max_new_tokens \
                        - len(r.generated):
                    bad.append(
                        f"slot {i} rid {r.rid}: remaining "
                        f"{self.remaining[i]} != budget "
                        f"{r.max_new_tokens} - emitted {len(r.generated)}")
                if int(self.remaining[i]) < 0:
                    bad.append(f"slot {i} rid {r.rid}: negative remaining")
        if len(set(self.prefill_fifo)) != len(self.prefill_fifo):
            bad.append(f"duplicate slots in prefill FIFO {self.prefill_fifo}")
        for i in self.prefill_fifo:
            if self.phase[i] != self.PREFILL:
                bad.append(f"slot {i} in prefill FIFO but {self.phase[i]}")
        return bad


# ---------------------------------------------------------------------------
# ExecutorBackend — the DEVICE half
# ---------------------------------------------------------------------------

class ExecutorBackend:
    """Owns the slot caches and every registered step program. The
    boundary loop calls only this contract:

      fresh()                                fresh slot caches for a run
      admit_full(params, row, slot)          monolithic admission
      run_chunk(params, row, slot, start, valid)   one (1,C) prefill chunk
      decode_step(params, tok, pos, act)     one slotted step (T == 1)
      decode_block(params, bucket, ...)      one T-micro-step block
      reset(slot) / has_reset                debug slot zeroing
      swap_out(slot) / swap_in(saved, slot, valid_len)   preemption pair

    Programs registered per backend and mode (one each, ``compiles`` ==
    1):

      colocated  chunked admission     serve_prefill_chunk
      colocated  monolithic admission  serve_prefill1 + serve_admit
                                       (tiered KV: serve_admit alone, the
                                       full-width chunk)
      colocated  T == 1                serve_decode
      colocated  T > 1                 serve_decode_block[_s{N}] per bucket
      colocated  drain mode            serve_prefill_batch +
                                       serve_decode_drain
      wa         chunked admission     serve_wa_prefill_chunk
      wa         monolithic admission  serve_wa_admit (full-width chunk)
      wa         T == 1                serve_wa_decode
      wa         T > 1                 serve_wa_decode_block[_s{N}]
      either     debug_reset_slots     serve_reset
      either     preemptible           serve_[wa_]swap_out +
                                       serve_[wa_]swap_in
    """

    program_prefix = "serve_"

    def __init__(self, api: ModelAPI, rt: StaticRuntime, *, mode: str,
                 slots: int, prompt_len: int, max_new_cap: int,
                 block_size: int, kv_bucket_chunk: int, prefill_chunk: int,
                 debug_reset_slots: bool, a_shards: int, overlap: int,
                 preemptible: bool, kv_extent: Optional[int] = None,
                 tiered: bool = False):
        self.api, self.rt = api, rt
        # on a mesh: this rank's share of the slots is the block of its
        # row along the batch axes (``slot_rows`` rows of ``local_slots``)
        self.ctx = ctx = api.ctx
        self.slot_rows = ctx.n(ctx.batch_axes) if ctx.active else 1
        self.local_slots = slots // self.slot_rows
        self.my_row = ctx.index(ctx.batch_axes) if ctx.active else 0
        # the slot caches' KV extent (None: no length axis, a recurrent
        # state or a ring) and whether they are tiered
        self.kv_extent, self.tiered = kv_extent, tiered
        self.device = api.device
        self.slots, self.prompt_len = slots, prompt_len
        self.max_new_cap = max_new_cap
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.a_shards = a_shards
        # micro-batch pipelining depth of the W/A boundary (WA backend
        # only; the engine validated it)
        self.overlap = overlap
        self.caches = None
        self.buckets: Tuple[int, ...] = ()
        self._decode_blocks: Dict[int, Any] = {}
        self._reset = None
        self._swap_out_p = self._swap_in_p = None
        if mode == "continuous":
            self._build_continuous(kv_bucket_chunk, prefill_chunk,
                                   debug_reset_slots)
            if preemptible:
                self._build_swap()
        else:
            self._build_drain()

    def _bucket_set(self, kv_bucket_chunk) -> Tuple[int, ...]:
        """Static KV bucket set of the block programs; with a_shards > 1
        every bucket splits into equal shard blocks (kv_buckets rounds the
        chunk up; the engine validated the extent). Caches with no KV
        extent (recurrent states, rings) get the one full program."""
        if self.kv_extent is None or kv_bucket_chunk <= 0:
            return (0,)
        return kv_buckets(self.kv_extent, kv_bucket_chunk, self.a_shards)

    def _build_reset(self, debug_reset_slots):
        if debug_reset_slots:
            self._reset = self.rt.compile_step("serve_reset",
                                               self.api.reset_slot)

    def _swap_export_fn(self, caches, slot):
        return export_slot_kv(caches, slot)

    def _swap_import_fn(self, caches, saved, slot, valid_len):
        return import_slot_kv(caches, saved, slot, valid_len)

    def _build_swap(self):
        """The token-exact preemption pair, one program each for every slot
        and length. ``swap_out`` is read-only (it returns copies of the
        slot's slices), so a failed or retried dispatch cannot touch the
        resident cache; ``swap_in`` writes positions below the true length
        in place."""
        self._swap_out_p = self.rt.compile_step(
            f"{self.program_prefix}swap_out", self._swap_export_fn)
        self._swap_in_p = self.rt.compile_step(
            f"{self.program_prefix}swap_in", self._swap_import_fn)

    def _greedy(self, logits):
        return self.api.greedy(logits) if self.api.greedy is not None \
            else torch.argmax(logits, dim=-1).to(torch.int32)

    def _postprocess(self, logits, positions, active):
        nxt = self._greedy(logits[:, 0])
        return torch.where(active, nxt, torch.zeros_like(nxt)), \
            positions + active.to(torch.int32)

    def _build_decode_programs(self, kv_bucket_chunk, slotted_fn, block_fn):
        """One ``{program_prefix}decode_block[_s{N}]`` per KV bucket for
        T > 1, else the single ``{program_prefix}decode`` step program. An
        overlap depth above 1 is recorded as the programs' ``overlap``
        meta."""
        meta = {"overlap": self.overlap} if self.overlap > 1 else None
        prefix = self.program_prefix
        if self.block_size > 1:
            self.buckets = self._bucket_set(kv_bucket_chunk)
            for sb in self.buckets:
                name = f"{prefix}decode_block" if len(self.buckets) == 1 \
                    else f"{prefix}decode_block_s{sb}"

                def block_step(p, caches, tok, pos, act, rem, eos, _sb=sb):
                    return block_fn(p, caches, tok, pos, act, rem, eos, _sb)

                self._decode_blocks[sb] = self.rt.compile_step(
                    name, block_step, meta=meta)
            return

        def decode_fn(p, caches, tokens, positions, active):
            caches, logits = slotted_fn(p, caches, tokens, positions, active)
            return (caches,) + self._postprocess(logits, positions, active)

        self._decode = self.rt.compile_step(f"{prefix}decode", decode_fn,
                                            meta=meta)

    def _build_continuous(self, kv_bucket_chunk, prefill_chunk,
                          debug_reset_slots):
        raise NotImplementedError

    def _build_drain(self):
        raise NotImplementedError

    @property
    def has_reset(self) -> bool:
        return self._reset is not None

    def _to_device(self, *rows: np.ndarray) -> List[torch.Tensor]:
        """Host operands in ONE host-to-device copy, unpacked on device (on
        a mesh, this rank's block of slots)."""
        packed = np.stack([np.asarray(r, np.int32) for r in rows])
        if self.slot_rows > 1:
            lo = self.my_row * self.local_slots
            packed = packed[:, lo:lo + self.local_slots]
        packed = torch.from_numpy(np.ascontiguousarray(packed))
        return list(packed.to(self.device).unbind(0))

    def _row_coords(self, row: int) -> Dict[str, int]:
        """The batch axes' coordinates of data row ``row``."""
        axes = self.ctx.batch_axes
        mesh = self.ctx.mesh
        coords = np.unravel_index(row, [mesh.shape[a] for a in axes])
        return {a: int(c) for a, c in zip(axes, coords)}

    def on_owner(self, slot: int, fn: Callable) -> torch.Tensor:
        """Run ``fn(local_slot)`` -> a device token tensor where the slot
        lives and return the token as a (1,) tensor. On a mesh the ranks
        of the slot's row run ``fn`` (batch-1 programs: admission); the
        row's first rank broadcasts the token and the names of the
        programs ``fn`` dispatched over the control group (a CPU tensor),
        and the other rows dispatch those programs without their bodies,
        so a seeded fault injector draws the same stream on every rank and
        a refused dispatch raises ``DispatchError`` on every rank."""
        if self.slot_rows == 1:
            return fn(slot)
        row, local = divmod(slot, self.local_slots)
        names = self.rt.step_names()
        # [token (-1: refused), indices of the dispatched programs, -1...]
        msg = torch.full((1 + len(names),), -1, dtype=torch.int64)
        refused = None
        if row == self.my_row:
            with self.rt.recording() as ran:
                try:
                    msg[0] = int(fn(local).reshape(-1)[0])
                except DispatchError as e:
                    refused = e
            msg[1:1 + len(ran)] = torch.tensor([names.index(n)
                                                for n in ran])
        mesh = self.ctx.mesh
        src = mesh.rank_at(**self._row_coords(row),
                           **{a: 0 for a in mesh.axis_names
                              if a not in self.ctx.batch_axes})
        msg = control_broadcast(msg, mesh, src)
        if refused is not None:
            raise refused
        if row != self.my_row:
            for i in msg[1:].tolist():
                if i >= 0:
                    self.rt.step(names[i]).dispatch_elsewhere()
            if msg[0] < 0:
                raise RuntimeError("a dispatch refused on the slot's row "
                                   "passed here: the ranks' fault streams "
                                   "diverged")
        return msg[:1]

    def fresh(self):
        self.caches = self.api.init_caches(self.slots,
                                           self.prompt_len + self.max_new_cap)

    def admit_full(self, params, row: np.ndarray, slot: int):
        raise NotImplementedError

    def run_chunk(self, params, row: np.ndarray, slot: int, start: int,
                  valid: int):
        """One fixed-(1,C) chunk at the slot's offset; returns the device
        tensor holding the chunk's last-valid-position argmax."""
        toks = torch.from_numpy(row[None]).to(self.device)

        def chunk(local):
            self.caches, tok = self._chunk(params, self.caches, toks, local,
                                           start, valid)
            return tok
        return self.on_owner(slot, chunk)

    def decode_step(self, params, last_tok, positions, active):
        tok, pos, act = self._to_device(last_tok, positions, active)
        self.caches, nxt, new_pos = self._decode(params, self.caches, tok,
                                                 pos, act.bool())
        return nxt, new_pos

    def decode_block(self, params, bucket, last_tok, positions, active,
                     remaining, eos):
        tok, pos, act, rem, eos_d = self._to_device(
            last_tok, positions, active, remaining, eos)
        self.caches, toks, emitted, last_d, pos_d, act_d, rem_d = \
            self._decode_blocks[bucket](params, self.caches, tok, pos,
                                        act.bool(), rem, eos_d)
        return toks, emitted, last_d, pos_d, act_d, rem_d

    def reset(self, slot: int):
        row, local = divmod(slot, self.local_slots)
        if row == self.my_row:
            self.caches = self._reset(self.caches, local)
        else:
            self._reset.dispatch_elsewhere()

    def swap_out(self, slot: int):
        """Export one slot's stored KV to the host. The resident caches
        are not modified. On a mesh every rank dispatches the program;
        the ranks of the slot's data row export their part (a
        ``RankImage``), the others only count the dispatch."""
        if not self.ctx.active:
            return _hosted(self._swap_out_p(self.caches, slot))
        row, local = divmod(slot, self.local_slots)
        if row != self.my_row:
            self._swap_out_p.dispatch_elsewhere()
            return RankImage(row, None)
        return RankImage(row, _hosted(self._swap_out_p(self.caches, local)))

    def stage_image(self, saved, slot: int):
        """The image ``saved`` where ``slot``'s data row can restore it.
        Collective on a mesh of several data rows, outside any dispatch:
        when the slot lies in another row than the image, each rank of the
        image's row sends its part to the rank of the slot's row at the
        same coordinates on the other axes (point to point over the
        control group), so every part lands where the same cut of the
        cache lives. One device, or one row: ``saved`` itself."""
        if self.slot_rows == 1:
            return saved
        row = slot // self.local_slots
        if saved.row == row:
            return saved
        mesh = self.ctx.mesh
        if self.my_row == saved.row:
            peer = mesh.rank_at(**self._row_coords(row))
            control_exchange([(t, peer) for t in saved.parts
                              if t is not None], [], mesh)
            return RankImage(row, None)
        if self.my_row != row:
            return RankImage(row, None)
        peer = mesh.rank_at(**self._row_coords(saved.row))
        parts = empty_slot_image(self.caches)
        control_exchange([], [(t, peer) for t in parts if t is not None],
                         mesh)
        return RankImage(row, parts)

    def swap_in(self, saved, slot: int, valid_len: int):
        """Restore an exported slot image below its true length (on a
        mesh: a ``RankImage`` already staged to the slot's row, restored
        there; the other rows only count the dispatch)."""
        if not self.ctx.active:
            self.caches = self._swap_in_p(self.caches, saved, slot,
                                          valid_len)
            return
        row, local = divmod(slot, self.local_slots)
        if row != self.my_row:
            self._swap_in_p.dispatch_elsewhere()
            return
        self.caches = self._swap_in_p(self.caches, saved.parts, local,
                                      valid_len)


def _hosted(saved):
    """An exported image on the host, as the reference's np.asarray (not
    a counted sync)."""
    return tuple(None if a is None else a.cpu() for a in saved)


class ColocatedBackend(ExecutorBackend):
    """Single-device executor running the family's own slotted programs."""

    def _build_continuous(self, kv_bucket_chunk, prefill_chunk,
                          debug_reset_slots):
        api, T = self.api, self.block_size
        self._prefill1 = None
        # a tiered cache admits through the chunk program even
        # monolithically: write_prefill has no cold-staging path, so
        # monolithic admission is the degenerate full-width chunk (padding
        # attended, cursor at the padded width)
        if prefill_chunk or self.tiered:
            def chunk_fn(p, caches, toks, slot, start, valid):
                caches, logits = api.prefill_chunk(p, caches, toks, slot,
                                                   start, valid)
                return caches, self._greedy(logits[:, -1])

            self._chunk = self.rt.compile_step(
                "serve_prefill_chunk" if prefill_chunk else "serve_admit",
                chunk_fn)
        else:
            def prefill1_fn(p, toks):
                caches, logits = api.prefill(p, toks)
                return caches, self._greedy(logits[:, -1])

            self._prefill1 = self.rt.compile_step("serve_prefill1",
                                                  prefill1_fn)
            self._admit = self.rt.compile_step("serve_admit", api.write_slot)
        self._build_reset(debug_reset_slots)
        n = self.a_shards
        self._build_decode_programs(
            kv_bucket_chunk,
            lambda p, c, t, pos, act: api.decode_slotted(p, c, t, pos, act,
                                                         kv_shards=n),
            lambda p, c, t, pos, act, rem, eos, sb: api.decode_block(
                p, c, t, pos, act, rem, eos, block_size=T, kv_bucket=sb,
                kv_shards=n))

    def _build_drain(self):
        api = self.api

        # on a mesh the rows are this rank's block of the slots and the
        # tokens the argmax across the vocabulary shards (``api.greedy``)
        def prefill_fn(p, toks):
            caches, logits = api.prefill(p, toks)
            return caches, self._greedy(logits[:, -1])

        def decode_fn(p, caches, tokens):
            caches, logits = api.decode(p, caches, tokens)
            return caches, self._greedy(logits[:, 0])

        self._prefill_b = self.rt.compile_step("serve_prefill_batch",
                                               prefill_fn)
        self._decode_b = self.rt.compile_step("serve_decode_drain",
                                              decode_fn)

    def admit_full(self, params, row: np.ndarray, slot: int):
        """Monolithic admission: batch-1 full-width prefill + slot write,
        or for a tiered cache ONE full-width chunk at start 0 that lands
        both tiers in the slot. Returns the device tensor holding the first
        token."""
        if self._prefill1 is None:
            return self.run_chunk(params, row, slot, 0, self.prompt_len)

        def admit(local):
            single, first = self._prefill1(
                params, torch.from_numpy(row[None]).to(self.device))
            self.caches = self._admit(self.caches, single, local)
            return first
        return self.on_owner(slot, admit)

    def drain_prefill(self, params, toks: np.ndarray):
        """Full-batch prefill of the (slots, prompt_len) prompt rows: fresh
        caches sized prompt_len + DECODE_SLACK and the first tokens (on a
        mesh, of this rank's block of the slots)."""
        if self.slot_rows > 1:
            lo = self.my_row * self.local_slots
            toks = toks[lo:lo + self.local_slots]
        return self._prefill_b(params, torch.from_numpy(
            np.ascontiguousarray(toks)).to(self.device))

    def drain_decode(self, params, caches, last):
        return self._decode_b(params, caches, last)


class WABackend(ExecutorBackend):
    """Weight–attention disaggregated executor: every step program runs
    ``core/wa.py``'s routed layer loop (QKV/FFN on W, KV writes, reads,
    bucket slices and attention on A), and so does the swap pair (on A).
    Continuous mode only.

    Admission is always the WA chunk program: the chunked lane runs the
    fixed (1,C) window; monolithic admission is the degenerate single
    full-width chunk (C = prompt_len, valid = prompt_len: padding
    attended, cursor at the padded width, the colocated monolithic
    semantics).

    ``routed_bytes`` meters the W<->A hops (``core/wa.py::routing_bytes``)
    from the runtime's dispatch counts: a decode dispatch routes the whole
    (B, d_model) batch twice a layer per micro-step, a prefill chunk its
    (C, d_model) window. A dispatch the interceptor refused is not counted,
    so it routes nothing."""

    program_prefix = "serve_wa_"

    def _swap_export_fn(self, caches, slot):
        return self.wa.swap_out_slot(caches, slot)

    def _swap_import_fn(self, caches, saved, slot, valid_len):
        return self.wa.swap_in_slot(caches, saved, slot, valid_len)

    def _build_continuous(self, kv_bucket_chunk, prefill_chunk,
                          debug_reset_slots):
        T = self.block_size
        self.wa = WADisaggregated(self.api.config, self.device,
                                  mesh=self.ctx.mesh if self.ctx.active
                                  else None, a_shards=self.a_shards,
                                  overlap=self.overlap)
        self._el = dtype_of(self.api.config).itemsize
        self._calls0: Dict[str, int] = {}

        def chunk_fn(p, caches, toks, slot, start, valid):
            caches, logits = self.wa.prefill_chunk(p, caches, toks, slot,
                                                   start, valid)
            return caches, self.wa.greedy(logits[:, -1])

        self._chunk = self.rt.compile_step(
            "serve_wa_prefill_chunk" if prefill_chunk else "serve_wa_admit",
            chunk_fn)
        self._build_reset(debug_reset_slots)
        self._build_decode_programs(
            kv_bucket_chunk,
            lambda p, c, t, pos, act: self.wa.decode_step_slotted(
                p, c, t, pos, act),
            lambda p, c, t, pos, act, rem, eos, sb: self.wa.decode_block(
                p, c, t, pos, act, rem, eos, block_size=T, kv_bucket=sb))

    # -- W<->A traffic model --------------------------------------------
    def expected_routing(self, name: str) -> Tuple[int, int]:
        """``(rows, trips)`` of ONE dispatch of program ``name``: it routes
        ``trips * routing_bytes(cfg, rows, el)`` W<->A bytes (``trips`` =
        micro-steps inside the program). The swap pair routes none."""
        if name in ("serve_wa_swap_out", "serve_wa_swap_in"):
            return 0, 0
        if name == "serve_wa_admit":
            return self.prompt_len, 1
        if name == "serve_wa_prefill_chunk":
            return self.prefill_chunk, 1
        if name == "serve_wa_decode":
            return self.slots, 1
        if name.startswith("serve_wa_decode_block"):
            return self.slots, self.block_size
        raise KeyError(f"no routing model for WA program {name!r}")

    @property
    def routed_bytes(self) -> int:
        """W<->A bytes of this run: each WA program's dispatches since
        ``fresh`` times what one dispatch routes."""
        total = 0
        for name, rec in self.rt.stats().items():
            if not name.startswith(self.program_prefix):
                continue
            rows, trips = self.expected_routing(name)
            total += (rec["calls"] - self._calls0.get(name, 0)) * trips * \
                routing_bytes(self.api.config, rows, self._el)
        return total

    def _greedy(self, logits):
        return self.wa.greedy(logits)

    def fresh(self):
        # the A domain's cache (on a mesh: its blocks of positions)
        self.caches = self.wa.init_cache(self.slots,
                                         self.prompt_len + self.max_new_cap)
        self._calls0 = {n: r["calls"] for n, r in self.rt.stats().items()}

    def admit_full(self, params, row: np.ndarray, slot: int):
        """Monolithic WA admission: one full-width chunk at start 0 (the
        padded width valid), straight into the slot."""
        return self.run_chunk(params, row, slot, 0, self.prompt_len)

    def routing_stats(self, decode_tokens: int) -> Dict[str, Any]:
        """The per-token "only embeddings move" claim (2 hops x L x
        d_model for one row) and the metered total of this run; both are
        overlap-invariant."""
        return {
            "routing_bytes_per_token": routing_bytes(self.api.config, 1,
                                                     self._el),
            "routing_total_bytes": int(self.routed_bytes),
            "routing_bytes_per_decode_token":
                float(self.routed_bytes / max(decode_tokens, 1)),
        }

    def overlap_stats(self, decode_time_s: float, macro_steps: int,
                      mb_live: int, mb_total: int) -> Dict[str, Any]:
        """Per-domain stall accounting of the overlap schedule: each
        domain's idle ticks are schedule arithmetic
        (``wa_schedule_occupancy``); the measured decode wall per
        macro-step splits by those fractions into W-idle and A-idle time.
        ``micro_batch_occupancy``: the share of dispatched micro-batches
        that carried a live slot (the scheduler's view)."""
        occ = wa_schedule_occupancy(self.api.config.n_layers, self.overlap)
        step_ms = decode_time_s * 1e3 / max(macro_steps, 1)
        return {
            "overlap": self.overlap,
            "overlap_efficiency": occ["overlap_efficiency"],
            "schedule_ticks": occ["total_ticks"],
            "w_busy_ticks": occ["w_busy_ticks"],
            "a_busy_ticks": occ["a_busy_ticks"],
            "w_idle_ms_per_macro_step": step_ms * occ["w_idle_frac"],
            "a_idle_ms_per_macro_step": step_ms * occ["a_idle_frac"],
            "micro_batch_occupancy": float(mb_live / max(mb_total, 1)),
        }


BACKENDS = {"colocated": ColocatedBackend, "wa": WABackend}


# ---------------------------------------------------------------------------
# KVArbiter — host-side accounting and policy for the tiered KV cache
# ---------------------------------------------------------------------------

class KVArbiter:
    """Host-side placement arbiter of the tiered KV cache.

    Demotion happens inside the step programs (the read-side cold boundary
    advances with each slot's cursor), so what is left for the host is
    accounting and policy: the arbiter observes per-slot cursors at the
    block boundaries the engine already syncs at (no device traffic),
    derives tier occupancy from the same ``cold_boundary`` arithmetic the
    programs run (its own copy, on host integers), counts demotions off
    cursor watermarks, tracks live and peak KV bytes against an optional
    byte budget (the engine preempts victims while over it) and recommends
    a placement from the observed pattern.

    The byte model reads off the cache's shapes and dtypes (a ``meta``
    cache will do): a hot token costs the compute dtype across every layer
    and KV head, K and V; a cold token costs the (packed) cold store plus
    its f32 scales. ``cold_bytes_saved`` prices the live cold tokens at the
    hot rate minus the cold rate."""

    def __init__(self, caches: KVCache, budget_bytes: int = 0):
        if not caches.is_tiered:
            raise ValueError("KVArbiter requires a tiered cache")
        self.hot_window = int(caches.hot_window)
        self.cold_block = int(caches.cold_block)
        self.cold_dtype = str(caches.cold_dtype)
        self.budget = int(budget_bytes)
        L, _, n_kv, S, hd_c = caches.k.shape
        H, hd = caches.hot_k.shape[3], caches.hot_k.shape[4]
        hot_el = caches.hot_k.element_size()
        cold_el = caches.k.element_size()
        scale_b = 0 if caches.k_scale is None \
            else caches.k_scale.element_size()
        # per-token rates, K + V, across all layers and KV heads
        self.hot_bytes_per_token = 2 * L * n_kv * hd * hot_el
        self.cold_bytes_per_token = 2 * L * n_kv * (hd_c * cold_el + scale_b)
        # the allocated footprint of ONE slot: full-extent cold store and
        # scales plus the hot ring
        self.kv_bytes_per_slot = (S * self.cold_bytes_per_token
                                  + H * self.hot_bytes_per_token)
        self.reset()

    def reset(self):
        """Per-run accounting reset (with the engine's accumulators)."""
        self._cursor: Dict[int, int] = {}
        self._watermark: Dict[int, int] = {}    # last-seen cold boundary
        self.demotions = 0                      # cold blocks crossed, total
        self.peak_bytes = 0
        self.peak_saved = 0
        self._last_rec = "no live slots observed"

    # -- bookkeeping (at host-sync boundaries only) ---------------------
    def _boundary(self, cursor: int) -> int:
        over = max(int(cursor) - self.hot_window, 0)
        return over // self.cold_block * self.cold_block

    def observe(self, slot: int, cursor: int):
        """One slot's cursor at a block boundary; each ``cold_block`` the
        boundary crossed since the last observation counts a demotion."""
        cursor = int(cursor)
        nb = self._boundary(cursor)
        prev = self._watermark.get(slot, 0)
        if nb > prev:
            self.demotions += (nb - prev) // self.cold_block
        self._watermark[slot] = nb
        self._cursor[slot] = cursor
        self.peak_bytes = max(self.peak_bytes, self.live_bytes())
        self.peak_saved = max(self.peak_saved, self.cold_bytes_saved())
        self._last_rec = self._recommend_live()

    def seed(self, slot: int, cursor: int):
        """Swap-in restore: the slot resumes at ``cursor`` with its cold
        prefix staged and already counted before the preemption; the
        watermark is seeded so nothing is counted twice."""
        cursor = int(cursor)
        self._watermark[slot] = self._boundary(cursor)
        self._cursor[slot] = cursor

    def release(self, slot: int):
        """Slot freed (retire, preempt, quarantine): its occupancy and
        watermark leave the live view; cumulative counters stay."""
        self._cursor.pop(slot, None)
        self._watermark.pop(slot, None)

    # -- occupancy / budget ---------------------------------------------
    def slot_occupancy(self, slot: int) -> Dict[str, int]:
        c = self._cursor.get(slot, 0)
        cold = self._boundary(c)
        hot = c - cold
        return {"slot": slot, "tokens": c, "hot_tokens": hot,
                "cold_tokens": cold,
                "kv_bytes": hot * self.hot_bytes_per_token
                + cold * self.cold_bytes_per_token}

    def live_bytes(self) -> int:
        """Occupancy-priced KV bytes of every live slot (hot tokens at the
        resident rate, cold tokens at the quantized rate)."""
        total = 0
        for c in self._cursor.values():
            cold = self._boundary(c)
            total += (c - cold) * self.hot_bytes_per_token \
                + cold * self.cold_bytes_per_token
        return total

    def cold_bytes_saved(self) -> int:
        saved_rate = self.hot_bytes_per_token - self.cold_bytes_per_token
        return sum(self._boundary(c) for c in self._cursor.values()) \
            * saved_rate

    def over_budget(self) -> bool:
        return bool(self.budget) and self.live_bytes() > self.budget

    # -- policy -----------------------------------------------------------
    def recommend(self) -> str:
        """Placement recommendation from the observed pattern; after a
        drained run (no live slots) the last live verdict stands."""
        return self._recommend_live() if self._cursor else self._last_rec

    def _recommend_live(self) -> str:
        cursors = list(self._cursor.values())
        if not cursors:
            return "no live slots observed"
        total = sum(cursors)
        cold = sum(self._boundary(c) for c in cursors)
        if cold == 0:
            return (f"working set fits hot_window={self.hot_window}; cold "
                    "tier idle — a smaller hot_window frees resident bytes")
        frac = cold / max(total, 1)
        if frac > 0.75 and self.cold_dtype == "int8":
            return ("cold tier dominates (>75% of tokens); int4 cold "
                    "storage would halve its footprint")
        if frac > 0.5 and self.cold_dtype == "bfloat16":
            return ("cold tier holds most tokens at full width; quantize "
                    "it (kv_cold_dtype=int8 or int4)")
        return "placement balanced for the observed access pattern"

    def stats(self) -> Dict[str, Any]:
        return {
            "hot_window": self.hot_window,
            "cold_block": self.cold_block,
            "cold_dtype": self.cold_dtype,
            "hot_bytes_per_token": self.hot_bytes_per_token,
            "cold_bytes_per_token": self.cold_bytes_per_token,
            "kv_bytes_per_slot": self.kv_bytes_per_slot,
            "kv_budget_bytes": self.budget,
            "demotions": self.demotions,
            "live_kv_bytes": self.live_bytes(),
            "peak_kv_bytes": self.peak_bytes,
            "cold_bytes_saved": max(self.peak_saved,
                                    self.cold_bytes_saved()),
            "per_slot": [self.slot_occupancy(s)
                         for s in sorted(self._cursor)],
            "recommendation": self.recommend(),
        }


# ---------------------------------------------------------------------------
# ServingEngine — the boundary loop
# ---------------------------------------------------------------------------

class ServingEngine:
    """Greedy decoding over fixed batch slots with per-slot admission.

    ``block_size`` (T): decode micro-steps per host round-trip (1 = one
    ``serve_decode`` program and one host sync per token).
    ``prefill_chunk`` (C): chunked-prefill lane; 0 = monolithic admission
    (prompts longer than ``prompt_len`` are rejected at submit, never cut).
    ``kv_bucket_chunk``: > 0 registers one decode-block program per KV
    bucket and picks the smallest covering bucket per macro-step.
    ``debug_reset_slots``: zero a slot's cache when its request retires.
    ``mode``: ``continuous`` (slot admission), ``drain`` (the
    drain-then-refill baseline) or ``auto`` (the default, as in the
    reference: continuous where the family has slotted decode and
    admission, else drain: the hybrid). ``prefill_chunk`` > 0 under
    ``auto`` on a family without ``prefill_chunk`` warns (``UserWarning``)
    and admits monolithically; under ``continuous`` it raises.
    ``a_shards`` (n): split-KV decode, each KV bucket read as n equal
    shards; the KV extent prompt_len + max_new_cap must divide by n.
    ``backend``: ``colocated`` (the family's own programs) or ``wa``
    (``WABackend``: the weight-attention split of ``core/wa.py``, the A
    domain on its own CUDA stream; continuous mode only).
    ``overlap`` (D, WA only): split each decode dispatch into D
    micro-batches pipelined across the W/A boundary; ``batch_slots`` must
    divide by D. ``stats()["wa"]`` reports the routed bytes and the
    schedule's occupancy.

    ``preemptible``: register the swap pair (``serve_swap_out`` /
    ``serve_swap_in``) and let a block boundary preempt a decoding slot:
    its stored KV goes to a host-side image, the slot serves higher-
    priority work (or yields to injected KV pressure), and the request is
    restored later with its cursors, token for token as if never
    preempted. Continuous mode only.
    ``max_queue``: > 0 sheds the lowest-priority (then most recently
    enqueued) queued request as a structured rejection whenever the queue
    exceeds the bound.
    ``max_retries`` / ``retry_backoff_s`` / ``watchdog_s``: every program
    dispatch retries up to ``max_retries`` times on ``DispatchError`` (with
    exponential backoff when ``retry_backoff_s`` > 0); a dispatch that
    exhausts the budget demotes the responsible request to a structured
    rejection and quarantines the slot whose cache bytes are suspect. A
    dispatch taking longer than ``watchdog_s`` bumps the watchdog counter.
    The watchdog times the HOST side of a dispatch, as the reference does
    (JAX dispatch is asynchronous too): PyTorch enqueues CUDA work and
    returns, and the engine does not synchronise the device to time it,
    so on the card it sees host stalls (an injected sleep, a slow launch
    path), not device time.
    ``strict_invariants``: check the scheduler's occupancy/cursor
    invariants at every block boundary; a violation raises
    ``AssertionError``.
    ``fault_injector``: a chaos hook (``repro_torch.runtime.faults.
    FaultInjector`` or compatible): its ``on_dispatch(name)`` is installed
    as the dispatch interceptor for the run, and its ``slots_held(step)``
    withholds that many slots at each boundary (KV pressure, answered by
    preemption when preemptible).
    ``kv_budget_bytes``: with a tiered cache (a config with ``hot_window``
    > 0, continuous mode only), the ``KVArbiter``'s byte budget: while the
    occupancy-priced live KV bytes exceed it, a block boundary preempts
    victims (``preemptible``) or holds admissions. ``stats()["tiered"]``
    reports the arbiter's view: demotions, per-slot tier occupancy, live
    and peak bytes, the bytes the cold tier saves and a recommendation.
    ``device``: must be the api's device; ``None`` means ``cuda`` (raises
    without a GPU unless ``device="cpu"`` is passed).
    ``ctx``: serve on a mesh, ``ShardingCtx(mesh, rules)`` of this rank
    (``api`` is the one-device API of the config; the engine builds the
    mesh's from it). Every rank runs the same loop in lock step on its
    share (its data row's slots; ``run``'s params are this rank's,
    ``param_specs.shard_params``); rank 0 decides TTFT shedding and the
    control group carries host results (``stats()["mesh"]``). Every rank
    dispatches every program, the ranks outside a slot's data row
    without its body, so a seeded fault injector draws one stream on all
    of them; a swap that fails on any rank fails on every rank. A
    preempted slot's image stays in parts on the ranks that held it
    (``RankImage``) and moves rank to rank only when it is restored into
    another data row.

    A ``run()`` may be repeated: per-run accumulators reset and the slot
    caches are allocated fresh, while the registered programs persist.
    """

    def __init__(self, api: ModelAPI, batch_slots: int, prompt_len: int,
                 runtime: Optional[StaticRuntime] = None,
                 mode: str = "auto",
                 max_new_cap: int = DECODE_SLACK, block_size: int = 1,
                 kv_bucket_chunk: int = 0, prefill_chunk: int = 0,
                 debug_reset_slots: bool = False,
                 backend: str = "colocated", a_shards: int = 1,
                 overlap: int = 1, preemptible: bool = False,
                 max_queue: int = 0, max_retries: int = 2,
                 retry_backoff_s: float = 0.0, watchdog_s: float = 0.0,
                 strict_invariants: bool = False,
                 fault_injector: Optional[Any] = None,
                 kv_budget_bytes: int = 0, device: DeviceLike = None,
                 ctx: Optional[ShardingCtx] = None):
        dev = resolve_device(device)
        if api.ctx.active:
            raise ValueError("the engine takes the one-device ModelAPI and "
                             "the mesh as ctx=ShardingCtx(mesh, rules)")
        self.ctx = ctx if ctx is not None else NULL_CTX
        one_device = api
        if self.ctx.active:
            # serve this rank's share: the API under the mesh's rules
            api = build_model(api.config, api.device, self.ctx)
        if dev != api.device:
            raise ValueError(f"engine device {dev} differs from the model's "
                             f"{api.device}; build both on one device")
        if mode not in ("auto", "continuous", "drain"):
            raise ValueError(mode)
        if api.config.family == "audio":
            # the reference resolves this family to drain and then fails
            # building its drain prefill, which passes tokens only
            raise ValueError(
                "the audio (enc-dec) family cannot be served by this "
                "engine: its prefill has no frames input (the reference "
                "engine fails the same plan with KeyError: 'frames' when "
                "it builds the drain prefill); run it at the model level "
                "through build_model(cfg).prefill(params, tokens, frames) "
                "and .decode")
        if a_shards < 1:
            raise ValueError(f"a_shards must be >= 1, got {a_shards}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose from "
                             f"{sorted(BACKENDS)}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got {prefill_chunk}")
        if overlap < 1:
            raise ValueError(f"overlap must be >= 1, got {overlap}")
        if overlap > 1:
            # micro-batch pipelining needs the W/A boundary (the WA
            # backend) and equal micro-batches
            if backend != "wa":
                raise ValueError(
                    f"overlap={overlap} pipelines the W/A boundary; the "
                    f"{backend} backend has no W↔A hops to overlap "
                    "(use backend='wa')")
            if batch_slots % overlap:
                raise ValueError(
                    f"batch_slots={batch_slots} does not divide into "
                    f"overlap={overlap} equal micro-batches")
        if backend == "wa":
            # the WA backend carries its own programs (core/wa.py): the
            # continuous scheduler and a family whose KV the W/A split can
            # decouple
            if mode == "drain":
                raise ValueError("the WA backend serves through the "
                                 "continuous scheduler; drain mode is "
                                 "colocated-only")
            if not api.wa_servable:
                raise ValueError(
                    f"{api.config.family} family has no WA-disaggregated "
                    "serving support")
            resolved = "continuous"
        else:
            # continuous mode needs a decode half (decode_block for T > 1,
            # decode_slotted for T == 1) and an admission half
            # (prefill_chunk for the chunked lane, write_slot for
            # monolithic admission)
            decode_ok = (api.decode_block is not None if block_size > 1
                         else api.decode_slotted is not None)
            if mode == "auto" and prefill_chunk > 0 \
                    and api.prefill_chunk is None:
                # fall back to monolithic admission, LOUDLY: a run that
                # asked for the chunk lane must not quietly measure the
                # monolithic one
                warnings.warn(
                    f"prefill_chunk={prefill_chunk} requested but the "
                    f"{api.config.family} family has no prefill_chunk "
                    "support; falling back to monolithic admission (the "
                    "chunked-prefill lane is OFF for this engine)",
                    UserWarning, stacklevel=2)
                prefill_chunk = 0
            admit_ok = (api.prefill_chunk is not None if prefill_chunk > 0
                        else api.write_slot is not None)
            slotted_ok = admit_ok and decode_ok
            if mode == "continuous" and not slotted_ok:
                raise ValueError(
                    f"{api.config.family} family has no "
                    f"{'chunked-prefill' if prefill_chunk > 0 else 'slotted'}"
                    " serving support")
            if mode == "drain" and prefill_chunk > 0:
                raise ValueError("chunked prefill requires the continuous "
                                 "scheduler (drain prefills the whole "
                                 "batch)")
            resolved = ("continuous" if slotted_ok else "drain") \
                if mode == "auto" else mode
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if self.ctx.active:
            self._check_mesh(api, resolved, batch_slots, prefill_chunk,
                             backend, overlap)
        self.api = api
        self.slots = batch_slots
        self.prompt_len = prompt_len
        self.max_new_cap = min(max_new_cap, DECODE_SLACK)
        self.mode = resolved
        if resolved == "drain":
            prefill_chunk = 0                    # auto fallback: no lane
        self.backend = backend
        self.block_size = block_size
        self.kv_bucket_chunk = kv_bucket_chunk
        self.prefill_chunk = prefill_chunk
        self.a_shards = a_shards
        self.overlap = overlap
        self.debug_reset_slots = debug_reset_slots
        self.preemptible = preemptible
        self.max_queue = max_queue
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.watchdog_s = watchdog_s
        self.strict_invariants = strict_invariants
        self.fault_injector = fault_injector
        # the slot caches' shapes without their memory: the KV extent and
        # the arbiter's byte model read off them (the tiered geometry is
        # validated here). No extent (None): no length axis to bound, a
        # recurrent state or a ring window
        caches_meta = one_device.init_caches(
            batch_slots, prompt_len + self.max_new_cap, device="meta")
        is_kv = isinstance(caches_meta, KVCache)
        self._kv_extent = caches_meta.k.shape[3] \
            if is_kv and not caches_meta.window else None
        tiered = is_kv and caches_meta.is_tiered
        self._tiered = tiered
        if tiered:
            # the tiered cache stages its cold prefix inside the chunk
            # program, which only the continuous scheduler has
            if self.mode != "continuous":
                raise ValueError(
                    "tiered KV caches (hot_window > 0) serve through the "
                    "continuous scheduler; drain mode has no chunk program "
                    "to stage the cold tier")
        if kv_budget_bytes < 0:
            raise ValueError(
                f"kv_budget_bytes must be >= 0, got {kv_budget_bytes}")
        if kv_budget_bytes and not tiered:
            raise ValueError(
                "kv_budget_bytes is the tiered-KV arbiter's pressure knob "
                "(hot_window > 0); flat caches have no arbiter to enforce "
                "it")
        self.kv_budget_bytes = kv_budget_bytes
        self._arbiter = KVArbiter(caches_meta, kv_budget_bytes) \
            if tiered else None
        if a_shards > 1:
            # split-KV decode shards the prefix-ordered KV walk of one
            # slot; a recurrent state or a ring has nothing to shard
            if self.mode == "drain":
                raise ValueError("split-KV decode (a_shards > 1) runs "
                                 "through the slotted decode programs; "
                                 "drain mode has none")
            if self._kv_extent is None:
                raise ValueError(
                    f"a_shards={a_shards} requires a prefix-ordered "
                    "(non-windowed) KV-cache family; the "
                    f"{api.config.family} family has no KV sequence axis "
                    "to shard")
            if self._kv_extent % a_shards:
                raise ValueError(
                    f"KV extent {self._kv_extent} (prompt_len + "
                    f"max_new_cap) not divisible by a_shards={a_shards}; "
                    "every shard must own an equal contiguous block")
        if prefill_chunk and is_kv and caches_meta.window:
            raise ValueError("chunked prefill requires a non-windowed KV "
                             "cache (ring order has no per-position write "
                             "offset)")
        if prefill_chunk and self._kv_extent is not None \
                and prefill_chunk > self._kv_extent:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} exceeds the KV extent "
                f"{self._kv_extent}; the fixed (1,C) window must fit the "
                "cache")
        if preemptible:
            # the swap pair moves one slot of a prefix-ordered KV cache at
            # its true length: recurrent states and rings have no such
            # slice, drain mode has no slot scheduler
            if self.mode != "continuous":
                raise ValueError("preemptible serving requires the "
                                 "continuous scheduler (drain has no slots "
                                 "to swap)")
            if self._kv_extent is None:
                raise ValueError(
                    "preemptible=True requires a prefix-ordered "
                    "(non-windowed) KV-cache family; the "
                    f"{api.config.family} family has no slot KV extent to "
                    "swap out")
        self.rt = runtime or StaticRuntime()
        self.queue: List[Request] = []
        self._ex: Optional[ExecutorBackend] = None
        self._reset_per_run()

    def _mesh_stats(self) -> Optional[Dict[str, Any]]:
        """Collective bytes per axis and per site, and the control group's
        broadcasts and gathers (no device syncs), since the meter was last
        reset; None off a mesh."""
        if not self.ctx.active:
            return None
        mesh = self.ctx.mesh
        return dict(meter(mesh).stats(), shape=dict(mesh.shape),
                    rules=self.ctx.rules.name, rank=mesh.rank)

    def _check_mesh(self, api, mode, slots, prefill_chunk, backend,
                    overlap):
        """What this slice serves on a mesh: the continuous scheduler (the
        colocated or WA (routing='sharding') backend) and drain mode
        (colocated, as everywhere: recurrentgemma's ``auto``), flat
        caches, rings and the recurrent states, tiered caches, preemption
        and KV budgets (each rank swaps its part of a slot; the arbiter
        prices the whole cache from cursors every rank holds), slots cut
        evenly over the batch axes; an MoE only with one data row (its
        experts' columns are cut over data, so a batch-1 admission on one
        row would need the others). whisper stays refused by the engine
        itself."""
        ctx = self.ctx
        rows = ctx.n(ctx.batch_axes)
        why = None
        if overlap > 1:
            why = "the overlap schedule (two streams of one card)"
        elif slots % rows:
            why = f"{slots} slots over {rows} data rows (must divide)"
        elif api.config.moe is not None and rows > 1:
            why = "an MoE with more than one data row"
        elif mode == "continuous" and backend == "colocated" \
                and not prefill_chunk and ctx.rules.rules.get("kv_seq"):
            why = ("monolithic admission under a sequence-cut cache "
                   "(+seqkv; use prefill_chunk)")
        if why:
            raise NotImplementedError(
                f"serving on a mesh does not run {why} in this slice of the "
                "port")

    def _reset_per_run(self):
        if self.ctx.active:
            meter(self.ctx.mesh).reset()
        self.tpot_samples: List[float] = []
        self.host_syncs = 0
        self._decode_tokens = 0
        self._decode_time = 0.0
        self._prefill_time = 0.0
        self._prefill_chunks = 0
        self._block_tokens: List[int] = []
        self._macro_steps = 0
        # micro-batch occupancy under overlap > 1 (scheduler view)
        self._micro_batches_live = 0
        self._micro_batches_total = 0
        self.queue = []
        # failure-model accounting
        self._rejected: List[Request] = []
        self._deadline_missed: List[Request] = []
        self._preemptions = 0
        self._restores = 0
        self._retries = 0
        self._watchdog_timeouts = 0
        self._swap_time = 0.0
        self._quarantined: set = set()
        # (rid, token index) in host-visible order: the chaos checker
        # proves from it that no token was duplicated, lost or reordered
        self._emit_log: List[Tuple[int, int]] = []
        self._cursor_watermark: Dict[int, int] = {}
        self._slot_cap = self.slots
        if self._arbiter is not None:
            self._arbiter.reset()

    def _emit_token(self, r: Request, tok: int):
        r.generated.append(int(tok))
        self._emit_log.append((r.rid, len(r.generated) - 1))

    def _finish(self, r: Request, now: float):
        r.status = "completed"
        r.t_done = now

    def _reject(self, r: Request, reason: str):
        r.status = "rejected"
        r.reject_reason = reason
        r.t_done = time.monotonic()
        r.swap = None                    # drop any held KV image
        self._rejected.append(r)

    def _miss_deadline(self, r: Request, reason: str):
        r.status = "deadline_missed"
        r.reject_reason = reason
        r.t_done = time.monotonic()
        r.swap = None
        self._deadline_missed.append(r)

    # -- hardened dispatch ---------------------------------------------
    def _dispatch(self, name: str, fn, *args):
        """Bounded retry-with-backoff around one program dispatch.
        ``DispatchError`` comes from the interceptor BEFORE the step
        touches its operands, so the dispatch retries verbatim; exhausting
        the budget raises ``DispatchFailure`` for the boundary loop to
        demote. Any other exception (a CUDA error, a failed kernel build or
        launch) is a real fault and propagates: it is never retried,
        demoted or quarantined. A dispatch whose host side takes longer
        than ``watchdog_s`` bumps the watchdog counter (the work did run)."""
        attempt = 0
        while True:
            t0 = time.monotonic()
            try:
                out = fn(*args)
            except DispatchError as e:
                if attempt >= self.max_retries:
                    raise DispatchFailure(name, attempt + 1, e) from e
                attempt += 1
                self._retries += 1
                if self.retry_backoff_s:
                    time.sleep(self.retry_backoff_s * (2 ** (attempt - 1)))
                continue
            if self.watchdog_s and time.monotonic() - t0 > self.watchdog_s:
                self._watchdog_timeouts += 1
            return out

    def _quarantine_slot(self, sched: SlotScheduler, slot: int):
        sched.quarantined.add(slot)
        self._quarantined.add(slot)

    def _host_sync(self, *tensors: torch.Tensor):
        """THE counted device-to-host round-trip of the decode loop: all
        operands travel in one packed int32 copy (one synchronisation) and
        come back as numpy arrays of their own shapes (``_to_host``)."""
        self.host_syncs += 1
        return self._to_host(*tensors)

    def _to_host(self, *tensors: torch.Tensor):
        """Device tensors as numpy arrays in one packed int32 copy; on a
        mesh of several data rows, every row's slots (the slot axis
        last). Not counted: ``_host_sync`` is the decode loop's."""
        flat = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors])
        host = flat.cpu()
        rows = None
        if self.ctx.active and self._ex.slot_rows > 1:
            # every data row's slots: the local results all-gathered over
            # the control group (CPU; not a device sync), slot axis last
            rows = control_all_gather(host, self.ctx.mesh,
                                      self.ctx.batch_axes).numpy()
        host = host.numpy()
        out, o = [], 0
        for t in tensors:
            n = t.numel()
            if rows is None:
                a = host[o:o + n].reshape(tuple(t.shape))
            else:
                a = np.concatenate([r[o:o + n].reshape(tuple(t.shape))
                                    for r in rows], axis=-1)
            out.append(a.astype(bool) if t.dtype == torch.bool else a)
            o += n
        return tuple(out) if len(out) > 1 else out[0]

    def _validate_request(self, r: Request):
        """Admission-time length contract: a prompt the engine cannot
        represent is rejected, never cut."""
        L = len(r.prompt)
        if L == 0:
            raise RequestRejected(r.rid, "empty prompt", length=0, limit=1,
                                  limit_name="min prompt length")
        if r.max_new_tokens < 1:
            raise RequestRejected(
                r.rid, f"max_new_tokens={r.max_new_tokens} must be >= 1",
                length=r.max_new_tokens, limit=1,
                limit_name="min max_new_tokens")
        if r.max_new_tokens > self.max_new_cap:
            raise RequestRejected(
                r.rid, f"max_new_tokens={r.max_new_tokens} exceeds cache "
                f"slack {self.max_new_cap} (raise max_new_cap)",
                length=r.max_new_tokens, limit=self.max_new_cap,
                limit_name="max_new_cap")
        if not self.prefill_chunk:
            if L > self.prompt_len:
                raise RequestRejected(
                    r.rid, f"prompt length {L} exceeds the static prompt "
                    f"width {self.prompt_len} (monolithic admission); raise "
                    "prompt_len or enable prefill_chunk > 0",
                    length=L, limit=self.prompt_len, limit_name="prompt_len")
        elif self._kv_extent is not None \
                and L + r.max_new_tokens > self._kv_extent:
            raise RequestRejected(
                r.rid, f"prompt length {L} + max_new_tokens="
                f"{r.max_new_tokens} exceeds the KV extent "
                f"{self._kv_extent} (chunked admission)",
                length=L + r.max_new_tokens, limit=self._kv_extent,
                limit_name="kv_extent")

    def submit(self, req: Request):
        self._validate_request(req)
        req.t_enqueue = time.monotonic()
        req.status = "queued"
        self.queue.append(req)

    def _prepare(self):
        if self._ex is None:
            self._ex = BACKENDS[self.backend](
                self.api, self.rt, mode=self.mode, slots=self.slots,
                prompt_len=self.prompt_len, max_new_cap=self.max_new_cap,
                block_size=self.block_size,
                kv_bucket_chunk=self.kv_bucket_chunk,
                prefill_chunk=self.prefill_chunk,
                debug_reset_slots=self.debug_reset_slots,
                a_shards=self.a_shards, overlap=self.overlap,
                preemptible=self.preemptible, kv_extent=self._kv_extent,
                tiered=self._tiered)

    @torch.inference_mode()
    def run(self, params, requests: List[Request],
            max_steps: int = 10_000) -> Dict[str, Any]:
        """Serve all requests (and any ``submit()``-ted before) to
        completion; returns latency stats."""
        pre = list(self.queue)
        seen = {id(r) for r in pre}
        requests = pre + [r for r in requests if id(r) not in seen]
        for r in requests:
            self._validate_request(r)
        self._prepare()
        self._reset_per_run()
        # installed (or cleared) per run, so a clean run on the same engine
        # sees no injected fault
        self.rt.set_interceptor(
            getattr(self.fault_injector, "on_dispatch", None)
            if self.fault_injector is not None else None)
        if self.mode == "continuous":
            return self._run_continuous(params, requests, max_steps)
        return self._run_drain(params, requests, max_steps)

    def _run_continuous(self, params, requests, max_steps):
        T = self.block_size
        ex = self._ex
        ex.fresh()
        sched = SlotScheduler(self.slots, requests, self.queue)
        self._sched = sched
        done: List[Request] = []
        steps = admissions = overlapped = 0
        while sched.work_remaining():
            if steps >= max_steps:
                break
            sched.pump(steps)
            if sched.usable_capacity() == 0:
                # every slot quarantined: nothing can be admitted again, so
                # the remaining work is rejected instead of spinning
                for r in sched.pending + sched.queue:
                    self._reject(r, "no usable slots (all quarantined)")
                sched.pending.clear()
                sched.queue.clear()
                break
            self._shed_deadlines(sched)
            self._bound_queue(sched)
            self._apply_pressure(sched, steps)
            self._apply_kv_budget(sched)
            self._priority_preempt(sched)
            batch_live = sched.occupied()
            while True:
                n_adm, n_ovl, fin = self._admission_phase(params, sched,
                                                          steps, batch_live)
                admissions += n_adm
                overlapped += n_ovl
                done.extend(fin)
                if not self.prefill_chunk:
                    break
                done.extend(self._advance_chunk_lane(params, sched))
                # one chunk per boundary protects LIVE decoders; with none
                # live keep chunking so a cold start does not serialize
                if sched.decode_active().any() or not sched.prefill_fifo:
                    break
            self._observe_tiers(sched)
            if self.strict_invariants:
                self._assert_invariants(sched)
            active = sched.decode_active()
            if not active.any():
                steps += 1                       # idle/prefill-only boundary
                continue
            done.extend(self._decode_round(params, sched, active))
            self._observe_tiers(sched)
            steps += T
        self._caches = ex.caches
        return self._stats(done, steps, admissions, overlapped)

    # -- pressure / deadline policies -------------------------------------
    def _shed_deadlines(self, sched: SlotScheduler):
        """A queued request whose TTFT deadline has passed can only miss:
        shed it now as deadline_missed. A preempted request already has its
        first token and is never TTFT-shed. On a mesh the clocks of the
        ranks differ: rank 0 decides and broadcasts the shed ids over the
        control group, so every rank sheds the same requests."""
        now = time.monotonic()
        shed = [r for r in sched.queue
                if r.ttft_deadline_ms > 0 and not r.generated
                and (now - r.t_enqueue) * 1e3 > r.ttft_deadline_ms]
        if self.ctx.active:
            mesh = self.ctx.mesh
            n = control_broadcast(torch.tensor([len(shed)]), mesh, 0)
            if int(n[0]):
                ids = control_broadcast(torch.tensor(
                    [r.rid for r in shed] or [0] * int(n[0])), mesh, 0)
                keep = set(ids.tolist())
                shed = [r for r in sched.queue if r.rid in keep]
            else:
                shed = []
        for r in shed:
            sched.queue.remove(r)
            self._miss_deadline(
                r, f"ttft_deadline_ms={r.ttft_deadline_ms:g} expired "
                   "in queue")

    def _bound_queue(self, sched: SlotScheduler):
        """Shed the lowest-priority (then most recently enqueued) request
        while the queue exceeds ``max_queue``; a preempted request (holding
        a swap image and emitted tokens) only when nothing else is left."""
        if not self.max_queue:
            return
        while len(sched.queue) > self.max_queue:
            pool = [r for r in sched.queue if r.swap is None] \
                or list(sched.queue)
            v = min(pool, key=lambda r: (r.priority, -r.t_enqueue, -r.rid))
            sched.queue.remove(v)
            self._reject(v, f"queue_full (max_queue={self.max_queue})")

    def _pick_victim(self, sched: SlotScheduler) -> Optional[int]:
        """Lowest-priority decoding slot; the most recently admitted within
        a priority class."""
        victims = sched.decode_slots()
        if not victims:
            return None
        return min(victims, key=lambda i: (sched.req[i].priority,
                                           -sched.req[i].t_admitted))

    def _apply_pressure(self, sched: SlotScheduler, steps: int):
        """KV pressure from the fault injector: ``slots_held`` slots are
        withheld this boundary. Decoding victims are preempted until the
        occupancy fits, and admissions are held to the same cap."""
        self._slot_cap = self.slots
        inj = self.fault_injector
        if inj is None or not self.preemptible:
            return
        held_fn = getattr(inj, "slots_held", None)
        if held_fn is None:
            return
        cap = max(0, self.slots - int(held_fn(steps)))
        self._slot_cap = cap
        for _ in range(self.slots):
            busy = sum(1 for p in sched.phase if p != sched.FREE)
            if busy <= cap:
                break
            v = self._pick_victim(sched)
            if v is None or not self._preempt_slot(sched, v):
                break

    def _apply_kv_budget(self, sched: SlotScheduler):
        """Real (not injected) KV pressure: while the arbiter's
        occupancy-priced live bytes exceed ``kv_budget_bytes``, preempt the
        usual victim; if that cannot get under the budget (or the engine is
        not preemptible), hold admissions this boundary: over-budget
        occupancy never grows."""
        arb = self._arbiter
        if arb is None or not arb.budget:
            return
        self._observe_tiers(sched)
        while self.preemptible and arb.over_budget():
            v = self._pick_victim(sched)
            if v is None or not self._preempt_slot(sched, v):
                break
        if arb.over_budget():
            busy = sum(1 for p in sched.phase if p != sched.FREE)
            self._slot_cap = min(self._slot_cap, busy)

    def _observe_tiers(self, sched: SlotScheduler):
        """The arbiter's per-slot cursor view at a host boundary: decoding
        slots report their host cursor, free (retired, preempted or
        quarantined) slots leave the live view. Host arithmetic only."""
        arb = self._arbiter
        if arb is None:
            return
        for i in range(sched.n):
            if sched.phase[i] == sched.DECODE:
                arb.observe(i, int(sched.positions[i]))
            elif sched.phase[i] == sched.FREE:
                arb.release(i)

    def _priority_preempt(self, sched: SlotScheduler):
        """While the queue's best request outranks the lowest-priority
        decoding slot and no usable slot is free, swap the victim out. A
        block boundary is the only preemption point."""
        if not self.preemptible:
            return
        for _ in range(self.slots):
            if not sched.queue or sched.usable_free() is not None:
                break
            head = sched.top_priority()
            v = self._pick_victim(sched)
            if v is None or sched.req[v].priority >= head:
                break
            if not self._preempt_slot(sched, v):
                break

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` on one device; on a mesh, whether any rank raised it
        (gathered over the control group), so that a swap that failed on
        one rank only counts as failed on every rank before any acts on
        it, and no rank enters a collective that another skips."""
        if not self.ctx.active:
            return flag
        got = control_all_gather(torch.tensor([int(flag)]), self.ctx.mesh,
                                 self.ctx.mesh.axis_names)
        return bool(got.any())

    def _preempt_slot(self, sched: SlotScheduler, slot: int) -> bool:
        """Swap one decoding slot out: export its stored bytes (read-only,
        so a failed dispatch leaves the victim decoding), host the image
        and the cursor triple on the request, free the slot and requeue.
        False if the swap-out dispatch failed."""
        ex = self._ex
        r = sched.req[slot]
        t0 = time.monotonic()
        failed = False
        try:
            saved = self._dispatch(ex.program_prefix + "swap_out",
                                   ex.swap_out, slot)
        except DispatchFailure:
            failed = True
        if self._any_rank(failed):
            return False                 # the victim keeps its slot
        self._swap_time += time.monotonic() - t0
        r.swap = SwapState(saved=saved,
                           kv_len=int(sched.positions[slot]),
                           last_tok=int(sched.last_tok[slot]),
                           remaining=int(sched.remaining[slot]))
        r.preemptions += 1
        self._preemptions += 1
        sched.preempt(slot)
        if self._arbiter is not None:
            self._arbiter.release(slot)
        return True

    def _restore(self, params, sched: SlotScheduler, slot: int,
                 r: Request) -> bool:
        """Swap a preempted request back in below its true length and
        resume decode with the saved cursor triple."""
        ex = self._ex
        st = r.swap
        t0 = time.monotonic()
        name = ex.program_prefix + "swap_in"
        saved = ex.stage_image(st.saved, slot)
        failed = False
        try:
            self._dispatch(name, ex.swap_in, saved, slot, st.kv_len)
        except DispatchFailure:
            failed = True
        if self._any_rank(failed):
            # the restore never ran (DispatchError fires before the body;
            # on a mesh, on at least one rank): the slot is FREE and will
            # be rewritten before it is read, the request is rejected
            self._reject(r, f"dispatch_failed:{name}")
            return False
        self._swap_time += time.monotonic() - t0
        r.swap = None
        sched.resume_decode(slot, r, st)
        if self._arbiter is not None:
            # the restored prefix's demotions were counted before the
            # preemption: seed the watermark so none is counted again
            self._arbiter.seed(slot, st.kv_len)
        self._restores += 1
        return True

    # -- admission ------------------------------------------------------
    def _admission_phase(self, params, sched: SlotScheduler, steps: int,
                         batch_live: bool):
        """Drain the queue into usable free slots in priority order. A
        preempted request re-enters DECODE through the swap-in program; a
        fresh one enters the chunk lane or admits monolithically. Returns
        (fresh admissions, overlapped, finished)."""
        admissions = overlapped = 0
        finished: List[Request] = []
        while True:
            busy = sum(1 for p in sched.phase if p != sched.FREE)
            if busy >= self._slot_cap:
                break                    # injected KV pressure holds slots
            slot = sched.usable_free()
            if slot is None:
                break
            r = sched.pop_queue()
            if r is None:
                break
            if r.swap is not None:
                self._restore(params, sched, slot, r)
                continue
            admissions += 1
            overlapped += int(batch_live)
            if self.prefill_chunk:
                sched.begin_prefill(slot, r, steps)
            else:
                finished.extend(self._admit_one_monolithic(
                    params, sched, slot, r, steps))
        return admissions, overlapped, finished

    def _admit_one_monolithic(self, params, sched: SlotScheduler, slot: int,
                              r: Request, steps: int) -> List[Request]:
        """Full-width batch-1 prefill + slot write; the prompt is zero-padded
        to ``prompt_len`` and the cursor starts at the padded width."""
        ex = self._ex
        r.t_admitted = time.monotonic()
        r.admit_step = steps
        r.status = "active"
        sched.req[slot] = r
        t0 = time.monotonic()
        try:
            first = self._dispatch(ex.program_prefix + "admit",
                                   ex.admit_full, params,
                                   pad_row(r.prompt, self.prompt_len), slot)
        except DispatchFailure as e:
            self._demote_admission(sched, slot, r, e)
            return []
        first_tok = int(first[0])                 # blocks: admission time
        now = time.monotonic()
        self._prefill_time += now - t0
        r.t_first_token = now
        r.note_emit(now)
        self._emit_token(r, first_tok)
        if r.done:
            self._finish(r, now)
            sched.req[slot] = None
            self._safe_reset(sched, slot)
            return [r]
        sched.start_decode(slot, self.prompt_len, r.generated[-1])
        return []

    def _demote_admission(self, sched: SlotScheduler, slot: int, r: Request,
                          exc: DispatchFailure):
        """An admission dispatch exhausted its retries: the slot may hold a
        partly written prompt, so the request is rejected and the slot
        quarantined (one poisoned request costs one slot, not the
        engine)."""
        self._reject(r, f"dispatch_failed:{exc.name}")
        sched.req[slot] = None
        sched.phase[slot] = sched.FREE
        if slot in sched.prefill_fifo:
            sched.prefill_fifo.remove(slot)
        self._quarantine_slot(sched, slot)

    def _safe_reset(self, sched: SlotScheduler, slot: int):
        """Debug slot zeroing; a reset that keeps failing quarantines the
        slot (its bytes are unknown) instead of ending the serve."""
        if not self._ex.has_reset:
            return
        try:
            self._dispatch("serve_reset", self._ex.reset, slot)
        except DispatchFailure:
            self._quarantine_slot(sched, slot)

    def _assert_invariants(self, sched: SlotScheduler):
        bad = sched.invariant_violations()
        for i in range(sched.n):
            r = sched.req[i]
            if r is None or sched.phase[i] != sched.DECODE:
                continue
            wm = self._cursor_watermark.get(r.rid, -1)
            pos = int(sched.positions[i])
            if pos < wm:
                bad.append(f"rid {r.rid}: cursor moved backwards "
                           f"{wm} -> {pos}")
            self._cursor_watermark[r.rid] = pos
        if bad:
            raise AssertionError("scheduler invariant violation(s): "
                                 + "; ".join(bad))

    def _advance_chunk_lane(self, params, sched: SlotScheduler):
        """Run at most one fixed-shape prefill chunk this boundary; the
        final chunk's logits give the first token and flip the slot to
        decode with its cursor at the TRUE prompt length."""
        ex = self._ex
        job = sched.next_chunk(self.prefill_chunk, self._kv_extent)
        if job is None:
            return []
        slot, r, start, n_valid = job
        row = pad_row(r.prompt[start:start + n_valid], self.prefill_chunk)
        t0 = time.monotonic()
        try:
            tok = self._dispatch(ex.program_prefix + "prefill_chunk",
                                 ex.run_chunk, params, row, slot, start,
                                 n_valid)
        except DispatchFailure as e:
            # the slot may hold a partly written prompt: reject, quarantine
            self._demote_admission(sched, slot, r, e)
            return []
        first_tok = int(tok[0])                   # blocks: chunk time
        now = time.monotonic()
        self._prefill_time += now - t0
        self._prefill_chunks += 1
        finished: List[Request] = []
        if sched.chunk_done(slot, start, n_valid):
            r.t_first_token = now
            r.note_emit(now)
            self._emit_token(r, first_tok)
            if r.done:
                self._finish(r, now)
                finished.append(r)
                sched.retire(slot)
                self._safe_reset(sched, slot)
            else:
                sched.start_decode(slot, len(r.prompt), r.generated[-1])
        return finished

    # -- decode round ---------------------------------------------------
    def _demote_decode(self, sched: SlotScheduler,
                       exc: DispatchFailure) -> np.ndarray:
        """A decode dispatch exhausted its retries. The fault is the
        dispatch, not one request: reject the lowest-priority decoder,
        quarantine its slot and return the smaller active mask, so the
        caller retries the round for the survivors (their KV is intact:
        the failed dispatch never ran)."""
        v = self._pick_victim(sched)
        if v is not None:
            self._reject(sched.req[v], f"dispatch_failed:{exc.name}")
            sched.retire(v)
            self._quarantine_slot(sched, v)
        return sched.decode_active()

    def _decode_round(self, params, sched: SlotScheduler, active):
        """One decode dispatch + ONE counted host sync: a slotted step
        (T == 1) or a T-micro-step block with on-device halting. A dispatch
        that exhausts its retries sheds one victim and retries for the
        survivors."""
        T = self.block_size
        ex = self._ex
        finished: List[Request] = []
        if ex.overlap > 1:
            # the share of dispatched micro-batches that carry a live slot
            # (an idle micro-batch still runs: the programs are static)
            for _slots, act in sched.micro_batch_view(ex.overlap, active):
                self._micro_batches_total += 1
                self._micro_batches_live += bool(act.any())
        if T == 1:
            while True:
                t0 = time.monotonic()
                try:
                    nxt, new_pos = self._dispatch(
                        ex.program_prefix + "decode", ex.decode_step,
                        params, sched.last_tok, sched.positions, active)
                except DispatchFailure as e:
                    active = self._demote_decode(sched, e)
                    if not active.any():
                        return finished
                    continue
                break
            nxt, new_pos = self._host_sync(nxt, new_pos)
            dt = time.monotonic() - t0
            self.tpot_samples.append(dt)
            self._decode_time += dt
            n_tok = int(active.sum())
            sched.positions = new_pos.copy()
            sched.last_tok = nxt.copy()
            now = time.monotonic()
            for i, r in enumerate(sched.req):
                if r is None or sched.phase[i] != sched.DECODE:
                    continue
                self._emit_token(r, nxt[i])
                # host mirror of the budget (the device keeps it only in
                # block mode): swap images and invariants see one form
                sched.remaining[i] -= 1
                r.note_emit(now)
                if r.done:
                    self._finish(r, now)
                    finished.append(r)
                    sched.retire(i)
                    self._safe_reset(sched, i)
        else:
            while True:
                # smallest bucket covering every live cursor for the whole
                # block; recomputed when a shed victim shrank the mask
                if len(ex.buckets) > 1:
                    needed = int(sched.positions[active].max()) + T
                    sb = bucket_for(min(needed, self._kv_extent), ex.buckets)
                else:
                    sb = ex.buckets[0]
                t0 = time.monotonic()
                try:
                    out = self._dispatch(
                        ex.program_prefix + "decode_block", ex.decode_block,
                        params, sb, sched.last_tok, sched.positions, active,
                        sched.remaining, sched.eos)
                except DispatchFailure as e:
                    active = self._demote_decode(sched, e)
                    if not active.any():
                        return finished
                    continue
                break
            toks, emitted, last_d, pos_d, act_np, rem_d = \
                self._host_sync(*out)
            dt = time.monotonic() - t0
            self.tpot_samples.append(dt / T)
            self._decode_time += dt
            sched.last_tok = last_d.copy()
            sched.positions = pos_d.copy()
            sched.remaining = rem_d.copy()
            n_tok = int(emitted.sum())
            now = time.monotonic()
            for i, r in enumerate(sched.req):
                if r is None or sched.phase[i] != sched.DECODE:
                    continue
                emitted_any = False
                for t in range(T):
                    if emitted[t, i]:
                        self._emit_token(r, toks[t, i])
                        emitted_any = True
                if emitted_any:
                    r.note_emit(now)
                if not act_np[i]:                # budget/EOS halt on device
                    self._finish(r, now)
                    finished.append(r)
                    sched.retire(i)
                    self._safe_reset(sched, i)
        self._decode_tokens += n_tok
        self._block_tokens.append(n_tok)
        self._macro_steps += 1
        return finished

    # -- drain mode -----------------------------------------------------
    def _run_drain(self, params, requests, max_steps):
        """The drain-then-refill baseline: the whole batch is prefilled
        only once every slot has drained, so one long request holds every
        queued request back. One decode step per boundary, one counted
        host sync per step. On a mesh every rank runs this loop in lock
        step over all the slots; its programs run on its data row's block
        of them, and the host reads every row's tokens (gathered over the
        control group within the one sync)."""
        ex = self._ex
        pending = sorted(requests, key=lambda r: r.arrival_step)
        active_req: List[Optional[Request]] = [None] * self.slots
        caches = last = None
        done: List[Request] = []
        steps = admissions = 0
        while pending or self.queue or any(r is not None for r in active_req):
            if steps >= max_steps:
                break
            while pending and pending[0].arrival_step <= steps:
                r = pending.pop(0)
                if not r.t_enqueue:           # keep a submit() stamp
                    r.t_enqueue = time.monotonic()
                r.status = "queued"
                self.queue.append(r)
            if caches is None:
                toks = np.zeros((self.slots, self.prompt_len), np.int32)
                for i in range(self.slots):
                    if active_req[i] is None and self.queue:
                        r = self.queue.pop(0)
                        r.t_admitted = time.monotonic()
                        r.admit_step = steps
                        r.status = "active"
                        active_req[i] = r
                        admissions += 1
                    if active_req[i] is not None:
                        toks[i] = pad_row(active_req[i].prompt,
                                          self.prompt_len)
                if not any(r is not None for r in active_req):
                    steps += 1                   # idle tick: await arrivals
                    continue
                t0 = time.monotonic()
                caches, last = ex.drain_prefill(params, toks)
                first = self._to_host(last)      # blocks: prefill time
                now = time.monotonic()
                self._prefill_time += now - t0
                for i, r in enumerate(active_req):
                    if r is not None and not r.generated:
                        r.t_first_token = now
                        r.note_emit(now)
                        self._emit_token(r, first[i])
                        if r.done:
                            self._finish(r, now)
            t0 = time.monotonic()
            caches, last = ex.drain_decode(params, caches, last)
            nxt = self._host_sync(last)
            dt = time.monotonic() - t0
            self.tpot_samples.append(dt)
            self._decode_time += dt
            self._macro_steps += 1
            steps += 1
            now = time.monotonic()
            n_tok = 0
            for i, r in enumerate(active_req):
                if r is None or r.done:
                    continue
                self._emit_token(r, nxt[i])
                r.note_emit(now)
                n_tok += 1
                if r.done:
                    self._finish(r, now)
            self._decode_tokens += n_tok
            self._block_tokens.append(n_tok)
            for i, r in enumerate(active_req):
                if r is not None and r.done:
                    done.append(r)
                    active_req[i] = None
            if all(r is None for r in active_req):
                caches = None                    # drained: allow re-prefill
        return self._stats(done, steps, admissions, 0)

    # ------------------------------------------------------------------
    def _stats(self, done, steps, admissions, overlapped) -> Dict[str, Any]:
        tp = np.array(self.tpot_samples[1:] or [0.0])
        per_req = [r.metrics() for r in sorted(done, key=lambda r: r.rid)]
        ttfts = np.array([m["ttft_ms"] for m in per_req] or [0.0])
        qd = np.array([m["queue_delay_ms"] for m in per_req] or [0.0])
        gaps = np.array([m["max_gap_ms"] for m in per_req] or [0.0])
        blk = np.array(self._block_tokens or [0.0])
        n_dec = self._decode_tokens
        dev = self.api.device
        out = {
            "mode": self.mode,
            "backend": self.backend,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "block_size": self.block_size,
            "a_shards": self.a_shards,
            "prefill_mode": ("chunked" if self.prefill_chunk
                             else "monolithic"),
            "prefill_chunk": self.prefill_chunk,
            "completed": len(done),
            "decode_steps": steps,
            "macro_steps": self._macro_steps,
            "admissions": admissions,
            "overlapped_admissions": overlapped,
            "tpot_mean_ms": float(tp.mean() * 1e3),
            "tpot_p50_ms": float(np.percentile(tp, 50) * 1e3),
            "tpot_p99_ms": float(np.percentile(tp, 99) * 1e3),
            "ttft_mean_ms": float(ttfts.mean()),
            "ttft_p99_ms": float(np.percentile(ttfts, 99)),
            "queue_delay_mean_ms": float(qd.mean()),
            "max_inter_token_gap_ms": float(gaps.max()),
            "decode_tokens": n_dec,
            "throughput_tok_s": float(n_dec / max(self._decode_time, 1e-9)),
            "prefill_time_ms": float(self._prefill_time * 1e3),
            "prefill_chunks": self._prefill_chunks,
            "host_syncs": self.host_syncs,
            "syncs_per_token": float(self.host_syncs / max(n_dec, 1)),
            "tokens_per_macro_step_mean": float(blk.mean()),
            "per_request": per_req,
            "runtime": self.rt.stats(),
            # failure-model counters: every submitted request ends in
            # exactly one of completed / rejected / deadline_missed
            "preemptions": self._preemptions,
            "restores": self._restores,
            "rejections": len(self._rejected),
            "deadline_misses": len(self._deadline_missed),
            "retries": self._retries,
            "watchdog_timeouts": self._watchdog_timeouts,
            "quarantined_slots": sorted(self._quarantined),
            "swap_time_ms": float(self._swap_time * 1e3),
            "rejected": [
                {"rid": r.rid, "status": r.status, "priority": r.priority,
                 "reason": r.reject_reason}
                for r in sorted(self._rejected + self._deadline_missed,
                                key=lambda r: r.rid)],
        }
        if self._arbiter is not None:
            # tier occupancy, demotions, live/peak bytes and the budget
            out["tiered"] = self._arbiter.stats()
        if self.ctx.active:
            out["mesh"] = self._mesh_stats()
        if self.backend == "wa" and self._ex is not None:
            # the routed W<->A bytes ("only embeddings move") and the
            # per-domain stall accounting of the overlap schedule
            out["wa"] = self._ex.routing_stats(n_dec)
            out["wa"].update(self._ex.overlap_stats(
                self._decode_time, self._macro_steps,
                self._micro_batches_live, self._micro_batches_total))
        return out
