"""Weight–attention (WA) disaggregated execution on one card: the port of
``repro.core.wa``.

The paper splits each transformer layer across two resource domains: the
weight domain W (ln1 + QKV projection, output projection + FFN; weights
resident, no KV) and the attention domain A (owns the KV state: appends,
reads, attention). Activations ("only embeddings") hop W -> A -> W once
per layer.

On one card the two domains are two CUDA streams. W is the caller's
current stream; A is a stream the engine owns. Each hop is an event
recorded on the producing stream that the consuming stream waits on just
before the op that reads it, and the hopped tensors are marked in use by
the consumer (``record_stream``) so the caching allocator cannot hand
their memory to the producer's next op while the consumer still reads it.
Every program forks A off W at entry (A then sees every cache write and
operand issued before it) and joins A back into W at exit (the caller's
host sync, the next program and the swap export see everything A wrote).
No call inside a program synchronises with the host. On the CPU both hops
are identities and everything runs in order.

``overlap`` = D > 1 splits the decode batch into D contiguous micro-batches
(``micro_batch_slices``) and issues their ops tick by tick along
``core.pipeline.skewed_schedule``: W's op for micro-batch m+1 and A's op
for micro-batch m are queued on their streams before either stream's next
tick, so the card can run them at once. Every op is row-wise over the
batch, so the split is token-exact.

This is the reference's ``routing="sharding"`` serving path with
``mesh=None`` (the hops there are no-ops and the math is the colocated
math).

On a mesh of ranks (``mesh=``) both routings of the reference run, with no
second stream:

- ``routing="sharding"`` (what the serving engine uses): every rank is in
  both domains, two rules tables over one mesh. W keeps ``sub_operator``
  (weights and heads on ``model``); A keeps ``seq_sharded_kv`` (each rank
  holds a block of every slot's positions; split-KV shards ride the same
  axis). The W -> A hop all-gathers q/k/v's heads, the A -> W hop slices
  the attention output back to W's heads, and only the (o, m, l) triples
  cross ranks in the attention's LSE merge.
- ``routing="device_put"``: ``split_mesh`` cuts the data rows into a W
  submesh and an A submesh of disjoint ranks (``WAPlan``). Each layer's
  q/k/v go from a W rank to the A rank of its column, and the attention
  output comes back, as point-to-point sends counted in the routing
  bytes. W holds the weights and returns the logits; A holds the cache.
  Per step only, as in the reference (no block or chunk program).

``wa_plan`` decides the split from ``core/residency.py``'s report (WA only
pays under cache pressure).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import torch

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.collectives import exchange
from repro_torch.core.pipeline import skewed_schedule
from repro_torch.core.residency import FAST_BYTES, HBM_BYTES
from repro_torch.core.residency import plan as residency_plan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kv.cache import KVCache, export_slot_kv, import_slot_kv
from repro_torch.models.common import greedy as greedy_ids
from repro_torch.models.registry import make_decode_block
from repro_torch.models.sharding import (NULL_CTX, MeshLayout, ShardingCtx,
                                         entry_of, layout, seq_sharded_kv,
                                         sub_operator)
from repro_torch.models.transformer import (attend_chunk,
                                            attend_chunk_seq,
                                            attend_decode_seq,
                                            attend_decode_slotted,
                                            check_supported,
                                            chunk_positions, embed_tokens,
                                            final_logits, make_cache,
                                            post_attention, pre_attention)
from repro_torch.quant.int4 import quantize_kv_int4
from repro_torch.quant.int8 import quantize_kv


# ---------------------------------------------------------------------------
# Mesh split + policy
# ---------------------------------------------------------------------------

def split_mesh(mesh, weight_rows: int):
    """Collective: the first ``weight_rows`` data rows as the weight
    submesh, the rest as the attention submesh (the paper's weight socket
    and attention socket). Returns (W, A), each a ``SubMesh`` for the ranks
    inside it and None for the others."""
    from repro_torch.launch.mesh import submesh
    if len(mesh.axis_names) != 2:
        raise ValueError("split on the single-pod (data, model) mesh")
    rows = mesh.devices_shape[0]
    return submesh(mesh, 0, weight_rows), submesh(mesh, weight_rows, rows)


@dataclass(frozen=True)
class WAPlan:
    separate: bool
    weight_rows: int
    attention_rows: int
    reason: str


def wa_plan(cfg: ModelConfig, shape: ShapeConfig, mesh,
            fast_bytes: float = FAST_BYTES,
            hbm_bytes: float = HBM_BYTES) -> WAPlan:
    """Separate W and A only where the residency planner finds the
    co-located hot set over budget (paper Fig 9); then half the data rows
    each. Reads ``mesh.devices_shape``; the budgets default to the
    H100's."""
    dims = mesh.devices_shape
    n_rows = dims[0]
    n_chips = 1
    for d in dims:
        n_chips *= d
    if cfg.family == "ssm":
        return WAPlan(False, n_rows, 0,
                      "attention-free: no growing KV to decouple "
                      "(DESIGN.md §6 — WA inapplicable)")
    rep = residency_plan(cfg, shape, n_chips, fast_bytes=fast_bytes,
                         hbm_bytes=hbm_bytes)
    if not rep.wa_profitable:
        return WAPlan(False, n_rows, 0,
                      "co-located hot set within budget; separation would "
                      "waste sockets (paper Fig 9 small-model regime)")
    half = n_rows // 2
    return WAPlan(True, half, n_rows - half, rep.notes)


def routing_bytes(cfg: ModelConfig, batch: int, bytes_per_el: int = 2) -> int:
    """Per-decoded-token W<->A activation traffic: 2 hops per layer of the
    (B, d_model) embedding, the paper's "only embeddings move". Invariant
    under ``overlap``: depth D routes D times as many hops of B/D rows."""
    return 2 * cfg.n_layers * batch * cfg.d_model * bytes_per_el


def micro_batch_slices(batch: int, depth: int) -> Tuple[slice, ...]:
    """Contiguous per-micro-batch row slices for overlap depth ``depth``:
    the one source of per-micro-batch slot membership, shared by the
    pipelined layer loop and ``SlotScheduler.micro_batch_view``."""
    if depth < 1:
        raise ValueError(f"overlap depth must be >= 1, got {depth}")
    if batch % depth:
        raise ValueError(
            f"batch {batch} does not divide into overlap depth {depth} "
            "equal micro-batches (pick slots divisible by overlap)")
    m = batch // depth
    return tuple(slice(i * m, (i + 1) * m) for i in range(depth))


# ---------------------------------------------------------------------------
# The hops
# ---------------------------------------------------------------------------

# the two hop sites (W -> A: a layer's q, k, v; A -> W: its attention
# output); each names its events, one per micro-batch
WA_HOP_TO_A = "wa_hop_to_a"
WA_HOP_TO_W = "wa_hop_to_w"


def _hop(tensors: Sequence[torch.Tensor], src: torch.cuda.Stream,
         dst: torch.cuda.Stream, ev: torch.cuda.Event) -> torch.cuda.Event:
    """Record ``ev`` on ``src`` after the tensors' producer, for ``dst`` to
    wait on before its consumer; each tensor is marked in use by ``dst``."""
    ev.record(src)
    for t in tensors:
        t.record_stream(dst)
    return ev


# ---------------------------------------------------------------------------
# Disaggregated engine
# ---------------------------------------------------------------------------

class WADisaggregated:
    """Weight ops on the W domain, attention on the A domain, activations
    routed per layer.

    Layer split (paper Fig 5b):
        W: x -> ln1 -> QKV proj ---route q,k,v---> A: append KV, attention
        W: o.Wo + residual + ln2 + FFN <--route o--'

    The FFN is the dense one or the MoE (router, dispatch, expert products
    and combine), both inside ``post_attention``, so an MoE layer's every
    op runs on W.

    The serving programs are ``decode_step_slotted``, ``decode_block``
    (the registry's ``make_decode_block`` lift of it) and
    ``prefill_chunk``; ``swap_out_slot`` / ``swap_in_slot`` are the A
    domain's preemption pair. Per-slot cursors, masks, tile limits and KV
    buckets are A-side: computed on the A stream from A-side operands.
    """

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None, *,
                 mesh=None, plan: Optional[WAPlan] = None,
                 routing: str = "sharding", a_shards: int = 1,
                 overlap: int = 1):
        if routing not in ("sharding", "device_put"):
            raise ValueError(routing)
        if routing == "device_put":
            if a_shards > 1 or overlap > 1:
                raise ValueError(
                    "device_put routing is per step: split-KV (a_shards > "
                    "1) and the overlap schedule need routing='sharding'")
            if mesh is None or plan is None:
                raise ValueError(
                    "routing='device_put' is the multi-device slice's W/A "
                    "routing between two disjoint sets of ranks: give it a "
                    "mesh and a WAPlan (the row split); on one card the two "
                    "domains are two CUDA streams (routing='sharding')")
        if a_shards < 1:
            raise ValueError(f"a_shards must be >= 1, got {a_shards}")
        if overlap < 1:
            raise ValueError(f"overlap must be >= 1, got {overlap}")
        if mesh is not None and overlap > 1:
            raise ValueError("overlap > 1 pipelines two CUDA streams of one "
                             "card; on a mesh it is not ported (overlap=1)")
        check_supported(cfg)
        self.cfg = cfg
        self.routing = routing
        self.plan = plan
        self.a_shards = a_shards
        self.overlap = overlap
        self.device = resolve_device(device)
        self.mesh = mesh
        self._a: Optional[torch.cuda.Stream] = None
        self.role = "both"
        self.w_ctx = self.a_ctx = NULL_CTX
        if mesh is not None and routing == "sharding":
            self.w_ctx = ShardingCtx(mesh, sub_operator(False))
            self.a_ctx = ShardingCtx(mesh, seq_sharded_kv(sub_operator(False)))
        elif mesh is not None:
            w_mesh, a_mesh = split_mesh(mesh, plan.weight_rows)
            if plan.weight_rows != plan.attention_rows:
                raise ValueError("device_put pairs each W rank with the A "
                                 "rank of its column: the plan must split "
                                 "the rows evenly")
            self.role = "w" if w_mesh is not None else "a"
            sub = w_mesh if w_mesh is not None else a_mesh
            ctx = ShardingCtx(sub, sub_operator(False))
            if self.role == "w":
                self.w_ctx = ctx
            else:
                self.a_ctx = ctx
            # the partner: the same column, the other half's row
            row = mesh.coords[mesh.axis_names[0]]
            other = row + plan.weight_rows if self.role == "w" \
                else row - plan.weight_rows
            self.partner = mesh.rank_at(**{mesh.axis_names[0]: other})
        self.w_lay = layout(cfg, self.w_ctx)
        self.a_lay = layout(cfg, self.a_ctx)
        if self.device.type == "cuda" and mesh is None:
            self._a = torch.cuda.Stream(self.device)
            # W: the caller's current stream, taken at each program entry
            self._w = torch.cuda.current_stream(self.device)
            # one event per hop site, re-recorded every program: a wait
            # enqueued on the other stream keeps the record it saw, and
            # each site's wait is enqueued before its next record
            self._events = {}
            # the quantizers fill their 0-d divisors once per device on
            # whichever stream calls first: fill them here, on W, before
            # any fork, so A never reads one before its fill has run
            z = torch.zeros((1, 1, 2), device=self.device)
            quantize_kv(z)
            quantize_kv_int4(z)
        vocab = self.w_lay.vocab
        self.greedy = lambda lg: greedy_ids(lg, self.w_ctx, vocab)
        self.decode_block = make_decode_block(self._decode_slotted_api,
                                              self.greedy)

    def init_cache(self, batch: int, max_len: int) -> KVCache:
        """The A domain's slot cache (this rank's part on a mesh: its block
        of positions under routing='sharding', its KV heads under
        device_put)."""
        return make_cache(self.cfg, batch, max_len, self.device, self.a_ctx)

    # -- hops on a mesh ---------------------------------------------------
    def _mesh_hop(self, t: torch.Tensor, src: MeshLayout, dst: MeshLayout,
                  site: str) -> torch.Tensor:
        """routing='sharding': move a (..., H, hd) tensor from one domain's
        head placement to the other's (an all-gather W -> A, a slice A ->
        W); nothing without a mesh."""
        if not self.w_ctx.active:
            return t
        lead = (None,) * (t.ndim - 2)
        return self.w_ctx.reshard(t, lead + (entry_of(src.kv_heads), None),
                                  lead + (entry_of(dst.kv_heads), None),
                                  site=site)

    # -- the two streams ------------------------------------------------
    def _event(self, site) -> torch.cuda.Event:
        ev = self._events.get(site)
        if ev is None:
            ev = self._events[site] = torch.cuda.Event()
        return ev

    @contextlib.contextmanager
    def _program(self):
        """One step program: fork A off W at entry, join A into W at exit
        (event record and wait only)."""
        if self._a is None:
            yield
            return
        w = self._w = torch.cuda.current_stream(self.device)
        fork = self._event("fork")
        fork.record(w)
        self._a.wait_event(fork)
        try:
            yield
        finally:
            join = self._event("join")
            join.record(self._a)
            w.wait_event(join)

    def _on_a(self):
        """Issue the enclosed ops on the A stream."""
        return contextlib.nullcontext() if self._a is None \
            else torch.cuda.stream(self._a)

    def _to_a(self, m: int, *tensors):
        """W -> A hop of micro-batch ``m``'s tensors just produced on W: the
        event A waits on before the op that reads them (None on the
        CPU)."""
        if self._a is None:
            return None
        return _hop(tensors, self._w, self._a, self._event((WA_HOP_TO_A, m)))

    def _a_op(self, m: int, ev, fn: Callable, *args):
        """Run ``fn(*args)`` on A after the W -> A event ``ev``; returns
        (output, the A -> W event W waits on before reading it)."""
        if self._a is None:
            return fn(*args), None
        self._a.wait_event(ev)
        torch.cuda.set_stream(self._a)
        try:
            o = fn(*args)
        finally:
            torch.cuda.set_stream(self._w)
        return o, _hop((o,), self._a, self._w, self._event((WA_HOP_TO_W, m)))

    def _to_w(self, ev):
        """W's side of the A -> W hop: wait before the consuming op."""
        if ev is not None:
            self._w.wait_event(ev)

    def _hand_to_w(self, tensors):
        """Tensors allocated on A that the caller reads on W."""
        if self._a is not None:
            for t in tensors:
                if t is not None:
                    t.record_stream(self._w)

    # -- preemption swap (A-domain slot state) ----------------------------
    def swap_out_slot(self, cache: KVCache, slot: int):
        """Export one slot's stored bytes on A (copies; the resident cache
        is not modified). The stored extent stays contiguous under
        split-KV, so the image restores under any shard width."""
        with self._program():
            with self._on_a():
                saved = export_slot_kv(cache, slot)
            self._hand_to_w(saved)
        return saved

    def swap_in_slot(self, cache: KVCache, saved, slot: int,
                     valid_len: int) -> KVCache:
        """Restore an exported slot image below its true length, on A."""
        with self._program():
            with self._on_a():
                cache = import_slot_kv(cache, saved, slot, valid_len)
            self._hand_to_w((cache.length,))
        return cache

    # -- the routed layer loop ----------------------------------------------
    def _layer_loop(self, params, cache: KVCache, tokens, positions,
                    slices: Tuple[slice, ...], attend: Callable,
                    head: Callable):
        """W -> A -> W per layer over the micro-batches ``slices``,
        issued tick by tick along ``skewed_schedule(2L+1, D)``: even ops
        are W's (embed + QKV of layer 0, post of layer j-1 + QKV of layer
        j, post of layer L-1 + ``head``), odd ops A's (``attend(m, kv, q,
        k, v)`` over layer j's cache rows of micro-batch m). With one
        slice this is the reference's sequential ``_layer_loop`` (and the
        colocated op order); with D it is ``_layer_loop_pipelined``.

        tokens/positions: (B,S) ids and RoPE phases. The reference gathers
        each micro-batch's cache rows from the entry stacks and assembles
        the updated stacks at the end (a functional-JAX device); here each
        micro-batch writes its own rows of the cache in place. The row
        sets are disjoint, so the values are identical. Returns the
        logits, micro-batches concatenated in row order."""
        L, D = self.cfg.n_layers, len(slices)
        blocks = params["blocks"]
        xs = [None] * D              # per-micro-batch residual (W side)
        routed = [None] * D          # in flight W -> A: ((q, k, v), event)
        backed = [None] * D          # in flight A -> W: (o, event)
        logits = [None] * D
        for _t, live in skewed_schedule(2 * L + 1, D):
            for m, op in live:
                sl, j = slices[m], op // 2
                if op % 2:
                    # -- A: attend layer j for micro-batch m --------------
                    (q, k, v), ev = routed[m]
                    routed[m] = None
                    kv = cache.layer(j)
                    if D > 1:
                        kv = tuple(None if c is None else c[sl] for c in kv)
                    backed[m] = self._a_op(m, ev, attend, m, kv, q, k, v)
                    continue
                # -- W: finish layer j-1, start layer j -------------------
                if j == 0:
                    x = embed_tokens(params, tokens[sl], positions[sl],
                                     self.cfg, self.w_lay)
                else:
                    (o, ev), backed[m] = backed[m], None
                    self._to_w(ev)
                    o = self._mesh_hop(o, self.a_lay, self.w_lay,
                                       WA_HOP_TO_W)
                    x = post_attention(blocks[j - 1], xs[m], o, self.cfg,
                                       self.w_lay)
                if j < L:
                    q, k, v = pre_attention(blocks[j], x, positions[sl],
                                            self.cfg, self.w_lay)
                    q, k, v = (self._mesh_hop(t, self.w_lay, self.a_lay,
                                              WA_HOP_TO_A) for t in (q, k, v))
                    routed[m] = ((q, k, v), self._to_a(m, q, k, v))
                    xs[m] = x
                else:
                    xs[m] = None
                    logits[m] = head(x)
        return logits[0] if D == 1 else torch.cat(logits)

    # -- decode ---------------------------------------------------------------
    def decode_step_slotted(self, params, cache: KVCache, tokens, positions,
                            active, kv_bucket: int = 0):
        """Continuous-batching decode: tokens/positions/active (B,) device
        tensors; row b appends at positions[b] and attends 0..positions[b]
        over the first ``kv_bucket`` positions (0: all). Returns (cache,
        logits (B,1,V) f32); the cache is updated in place. Each
        micro-batch's tile limit ``max(positions[active]) + 1`` is computed
        on A at the fork. No host sync. On a mesh the rows are this data
        row's (the caller cuts them), except under device_put, which takes
        the global batch (``_decode_device_put``)."""
        if self.routing == "device_put":
            return self._decode_device_put(params, cache, tokens, positions,
                                           active, kv_bucket)
        slices = micro_batch_slices(tokens.shape[0], self.overlap)
        with self._program():
            with self._on_a():
                a_side = []
                for sl in slices:
                    pos, act = positions[sl], active[sl]
                    live = torch.where(act, pos, torch.full_like(pos, -1))
                    a_side.append((pos, act,
                                   (live.max() + 1).to(torch.int32)))

            def attend(m, kv, q, k, v):
                # append at the per-slot cursors and attend the bucket
                # prefix (split-KV with a_shards > 1; tiered slices resolve
                # the hot/cold image); the reference's shared-cursor
                # _a_attend is this with every row at one cursor. On a mesh
                # this rank holds a block of positions: K1 partials merged
                # across the A domain's ranks
                pos, act, lim = a_side[m]
                if cache.seq_axes:
                    return attend_decode_seq(
                        q, k, v, kv, pos, act, self.cfg, kv_bucket, lim,
                        self.a_shards, self.a_ctx, cache.seq_axes,
                        cache.seq_lo)
                return attend_decode_slotted(q, k, v, kv, pos, act, self.cfg,
                                             kv_bucket, lim, self.a_shards)

            logits = self._layer_loop(
                params, cache, tokens[:, None], positions[:, None], slices,
                attend, lambda x: final_logits(params, x, self.cfg,
                                               self.w_lay))
        cache.length = torch.maximum(
            cache.length, (torch.where(active, positions, 0).max() + 1)
            .to(torch.int32))
        return cache, logits

    def _decode_device_put(self, params, cache: Optional[KVCache], tokens,
                           positions, active, kv_bucket: int = 0):
        """routing='device_put': W ranks (``params``: their shards) run
        embed, ln1/QKV, wo/FFN and the logits; A ranks (``cache``: their
        part) append and attend. Per layer each W rank sends q, k, v to the
        A rank of its column and receives the attention output back.
        tokens/positions/active are the GLOBAL batch; each side cuts its
        data row's rows. Returns (cache on A / None on W, logits on W / None
        on A (this rank's vocabulary rows))."""
        cfg, hd = self.cfg, self.cfg.head_dim
        if self.role == "w":
            ctx, lay = self.w_ctx, self.w_lay
        else:
            ctx, lay = self.a_ctx, self.a_lay
        tok, pos, act = (ctx.batch_local(t) for t in (tokens, positions,
                                                      active))
        B = tok.shape[0]
        nh = ctx.n(entry_of(lay.kv_heads))
        shape_q = (B, 1, cfg.n_heads // nh, hd)
        shape_kv = (B, 1, cfg.n_kv_heads // nh, hd)
        dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
        mesh = self.mesh
        if self.role == "w":
            x = embed_tokens(params, tok[:, None], pos[:, None], cfg, lay)
            for lp in params["blocks"]:
                q, k, v = pre_attention(lp, x, pos[:, None], cfg, lay)
                exchange([(q, self.partner), (k, self.partner),
                          (v, self.partner)], [], mesh, "wa", WA_HOP_TO_A)
                o = torch.empty(shape_q[:1] + shape_q[2:], dtype=dt,
                                device=x.device)
                exchange([], [(o, self.partner)], mesh, "wa", WA_HOP_TO_W)
                x = post_attention(lp, x, o, cfg, lay)
            return None, final_logits(params, x, cfg, lay)
        live = torch.where(act, pos, torch.full_like(pos, -1))
        lim = (live.max() + 1).to(torch.int32)
        dev = cache.k.device
        for j in range(cfg.n_layers):
            q = torch.empty(shape_q, dtype=dt, device=dev)
            k = torch.empty(shape_kv, dtype=dt, device=dev)
            v = torch.empty(shape_kv, dtype=dt, device=dev)
            exchange([], [(q, self.partner), (k, self.partner),
                          (v, self.partner)], mesh, "wa", WA_HOP_TO_A)
            o = attend_decode_slotted(q, k, v, cache.layer(j), pos, act, cfg,
                                      kv_bucket, lim)
            exchange([(o, self.partner)], [], mesh, "wa", WA_HOP_TO_W)
        cache.length = torch.maximum(
            cache.length, (torch.where(act, pos, 0).max() + 1)
            .to(torch.int32))
        return cache, None

    def decode_step(self, params, cache: KVCache, tokens):
        """Shared-cursor decode step: every row live at ``cache.length``
        (the slotted step at one device cursor, no host sync)."""
        B = tokens.shape[0]
        return self.decode_step_slotted(
            params, cache, tokens, cache.length.expand(B),
            torch.ones(B, dtype=torch.bool, device=tokens.device))

    def _decode_slotted_api(self, params, caches, tokens, positions, active,
                            kv_bucket: int = 0, kv_shards: int = 1):
        """``ModelAPI.decode_slotted``-shaped adapter for
        ``make_decode_block``: the split width is this engine's
        ``a_shards``."""
        del kv_shards
        return self.decode_step_slotted(params, caches, tokens, positions,
                                        active, kv_bucket=kv_bucket)

    # -- chunked prefill -------------------------------------------------------
    def prefill_chunk(self, params, cache: KVCache, tokens, slot: int,
                      start: int, valid_len: int):
        """WA chunked prefill of slot ``slot``: tokens (1,C) at positions
        [start, start+valid_len); positions >= valid_len are padding,
        never written. W runs embed/ln1/QKV and Wo/ln2/FFN; A writes the
        chunk's K/V at the slot's offset, reads the stored prefix back and
        runs chunk attention (its positions and masks made on A). Returns
        (cache, logits (1,1,V)) at the chunk's last valid position."""
        if self.routing == "device_put":
            raise ValueError(
                "prefill_chunk must run as one program over both domains; "
                "device_put routing is per decode step — build "
                "WADisaggregated(routing='sharding') for the serving path")
        C = tokens.shape[1]
        with self._program():
            with self._on_a():
                a_pos = chunk_positions(start, C, self.device)

            def attend(m, kv, q, k, v):
                if cache.seq_axes:
                    return attend_chunk_seq(q, k, v, kv, slot, start,
                                            valid_len, a_pos, self.cfg,
                                            self.a_ctx, cache.seq_axes,
                                            cache.seq_lo)
                return attend_chunk(q, k, v, kv, slot, start, valid_len,
                                    a_pos, self.cfg)

            logits = self._layer_loop(
                params, cache, tokens, chunk_positions(start, C, self.device),
                (slice(0, 1),), attend,
                lambda x: final_logits(params, x[:, valid_len - 1:valid_len],
                                       self.cfg, self.w_lay))
        cache.length = torch.clamp_min(cache.length, start + valid_len)
        return cache, logits
