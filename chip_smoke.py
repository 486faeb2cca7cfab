"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``), never the JAX package, through five
phases; any failure exits non-zero before the result line:

1. build the three CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   with nvcc for sm_90a (one nvcc per source, all at once);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and across the kernels' tiling boundaries (K1 flash
   decode at S from 1 to 4096, B 1, 2, 4 and 8 (the WA backend's
   micro-batches launch it at 4 and 2 rows), the four q/KV dtype pairs,
   kv_limit at 0, inside a split, on a split edge and at S, normalised and
   partial, and at G*hd = 1024; at the other configurations' groups with
   hd 128 and the engine runs' bucket extents: G=16 (qwen3-moe: two
   launches of 8 heads), 4 (at B 1, 2, 4 and 8), 3 and 1;
   split-KV attention, one K1 partial launch per shard plus the LSE
   combine, over buckets 64/128/192/200 x 2 and 4 shards x bf16 and int8
   KV, against a float64 evaluation of the same function on the host;
   K3 fused FFN up to 1,024 rows, also at Llama-2-7B's D=4096 F=11008;
   K4 int8 GEMV at 1 to 128 rows (2 and 4 included) and at the paper's
   Llama projections (4096x4096, 4096x11008, 11008x4096,
   3072x8192) and phi3.5-moe's k/v (4096x1024) at 1 to 128 rows — K4
   must be bit-exact; K1 over recurrentgemma's ring at hd 256 (16 query
   heads on one KV head: four launches of 4 heads; and G=4, one launch)
   at B 1, 2, 4 and 8 over ring extents 64, 256 and 2,048, the cursor at
   0, mid-ring, the last slot and wrapped (the windowed mask of
   ``slot_valid_mask``), bf16 and int8 KV (f32 at B 1 and 2); K3 in its
   gelu mode at recurrentgemma's FFN (D=4096, F=12288) at 1 to 1,024
   rows; K1 at whisper's heads (G=1, hd 64, 16 KV heads; B 1, 2 and 8)
   over the cross K/V of 1,500 frames (all-true mask, kv_limit S, bf16
   and f32) and the self cache at extents 160 and 288 with kv_limit edges
   (bf16 and int8 KV); K3 at internvl2's FFN (D=8,192, F=28,672) at 1, 8,
   128 and 768 bf16 rows and 576 f32 rows (32-row tiles); K4 at whisper's
   1024x1024, 1024x4096 and 4096x1024 at 1 to 8 rows; K3 with a gradient
   (the ``FusedFFN`` autograd.Function: the kernel's forward, the plain
   f32 products of its backward) at the training shape (2,048 rows,
   D=896, F=4,864) and at 17 rows, bf16 and f32, silu and gelu: dx and
   the three weight gradients against autograd of the plain version on
   the same CUDA tensors, one K3 launch a forward; every kernel must give
   the same bits on a second call);
3. model parity at full qwen2-0.5b width, depth cut to 2 layers, float32:
   the same seeded weights on the CPU (plain versions) and on CUDA
   (kernels) give equal tokens and logits within 1e-3 of max|logit|, for
   slotted decode, the decode block, split-KV decode (4 shards); on CUDA
   the shared-cursor decode step equals slotted decode at one cursor; the
   preemption swap pair (export, then import at valid_len 1, 37, 200, and
   its 4-shard views) gives the CPU's bytes for float32 and int8 KV; the
   tiered cache functions (append, chunk writes, one wrapping the ring,
   the chunk program's hot image, the resolved read and its 4-shard views,
   export and import at valid_len 1, 37, 200) give the CPU's bytes for
   int8 and int4 cold; and over a tiered cache, chunked prefill across
   cold boundaries, slotted decode, the decode block and 4-shard split
   decode give the CPU's tokens and logits within 1e-3; the WA programs
   (``core/wa.py``: chunked prefill, slotted decode, the decode block) at
   overlap 1, 2 and 4 over flat f32 KV, int8 KV, int8 weights with int8
   KV (K4 at the micro-batches' rows), 4 shards and a tiered int4 cache
   give the CPU's tokens and logits within 1e-3, and the
   largest difference between WA at depth 1 and the colocated programs
   on the card is reported (the same kernels on two streams); the MoE
   family at full phi3.5-moe width (16 experts x 6400, LayerNorm), 2
   layers: chunked prefill, slotted decode, the decode block, 4-shard
   split decode and the WA programs at overlap 1, 2 and 4 give the CPU's
   tokens and logits within 1e-3 (2e-2 in a program where the recorded
   routings of the two sides differ), and WA at depth 1 gives the
   colocated logits bit for bit; mamba2 at full width, 2 layers
   (monolithic prefill, a prompt in 3 chunks, the last partial, slotted
   decode with one inactive row whose state must keep its bytes, the
   decode block) and recurrentgemma at full width, 4 layers (one
   superblock and a tail layer, window cut to 64, vocabulary to 32,000
   for the CPU side; a 96-token prefill rolls the ring, 48 decode steps
   wrap it) give the CPU's tokens and logits within 1e-3 at every step;
   whisper at full width, 2 encoder + 2 decoder layers over 1,500 frames
   (f32; int8 weights + int8 KV with the card's quantized activations
   replayed on the CPU) and internvl2 at full width, 2 layers (vocabulary
   cut to 32,000, 256 vision embeddings before a 32-token text) give the
   CPU's tokens and logits within 1e-3 at every step and its caches
   (whisper's self and cross K/V); training at full width, 2 layers, f32:
   the loss (``ModelAPI.loss``) and every gradient leaf of qwen2-0.5b
   (batch 2 x 128; K3 twice a layer: forward and the remat recompute) and
   mamba2-1.3b (2 x 512: two SSD chunks) on the CPU against CUDA, the
   loss within 1e-5 relative, each leaf within 1e-3 of its largest
   magnitude plus 1e-5 of the largest gradient;
4. the serving engine at full qwen2-0.5b width (24 layers; runs (b),
   (e)-(h), (j) and (k) cut to 8, to keep the script's
   time; seeded random
   bf16 weights): (a) chunked admission + macro-step decode + KV buckets,
   (b) int8 weights and int8 KV with monolithic admission, (c) per-token
   decode, (d) drain mode (batch prefill of 8 x 128, shared-cursor
   decode), (e) run (a) with int8 KV and split-KV decode over 4 shards,
   (g) run (a) over a tiered cache (hot window 64, blocks of 16, int4
   cold: the boundary moves from 64 to 128 during decode); every request
   must complete and every kernel of each run must have been launched
   (counts reset just before the run); drain must admit no request while
   another decodes; (e) and (g) must make as many host syncs as (a), and
   (g) must demote; one decode block of (a), (b), (e) and (g) is traced
   with torch.profiler and counted for synchronising calls; (h) monolithic
   tiered admission (the full-width ``serve_admit`` chunk; hot 32, blocks
   of 16, int8 cold) with split-KV decode over 4 shards, preemptible,
   served with no budget and then under a ``kv_budget_bytes`` of five
   slots priced by the arbiter: both complete with the same tokens, the
   budget preempts and restores, and K1 (partial) and K3 launch; (f) the
   failure model: a seeded
   chaos schedule (``run_chaos``: a clean run, then injected dispatch
   failures, KV pressure and a high-priority arrival) over 4 slots with
   int8 KV, preemptible, a bounded queue and strict invariants, which must
   audit clean, finish with the clean run's tokens, preempt and restore,
   and launch K1 and K3 in both runs; (i) run (a) through the WA backend
   (``backend="wa"``, the KV side on its own CUDA stream) must give (a)'s
   tokens and host syncs; (k) run (b) through the WA backend at overlap 1
   (the WA admission program, whole batches) and (j) at overlap 2, served
   twice, must give (b)'s host syncs, and (j) the same tokens twice; how
   many streams of (k) equal (b)'s (the admission program's share of any
   difference) and of (j) equal (k)'s (the micro-batching's share) is
   reported; the traced blocks of (i) and (j) also
   report each stream's busy time and the time both streams run a kernel
   beside the schedule's ``overlap_efficiency``; then the other
   configurations at full width: (l) qwen3-moe-235b-a22b cut to 4 layers
   on (a)'s plan (K1 only, two launches a layer), (m) phi3.5-moe-42b cut
   to 4 layers with int8 weights and KV through the WA backend at overlap
   2 on (j)'s plan, served twice, and (n) the paper's Llama-2-7B int8
   deployment (8 of 32 layers) on (b)'s plan; each must complete, launch
   exactly its path's kernels (no K3 in any) and make its twin run's
   host syncs; one decode block of (l) and (n) is traced; then the
   recurrent families at full width: (o) mamba2-1.3b (6 of 48 layers)
   on (a)'s plan, which must complete, launch no kernel of the port (the
   counts stay 0: the SSD has none), make the host syncs of the same plan
   served on the CPU and register one decode-block program (no buckets),
   and (p) recurrentgemma-9b with ``mode="auto"``, which must resolve to
   drain (no slotted API), complete with no admission while another
   request decodes, and launch K1 and K3 (and not K4) (6 of 38 layers:
   2 superblocks); one decode block
   of (o) and three drain steps of (p) are traced, with no synchronising
   call; then (q) internvl2-76b at full width cut to 4 of 80 layers,
   text-only through the engine on (a)'s plan with monolithic admission
   (the family has no chunk lane), which must resolve to continuous,
   complete, launch K1 and K3 once a layer each decode step and never K4,
   and make the host syncs of its plan on the CPU; and (r) whisper-medium
   at full width, 12 + 12 of its 24 + 24 layers, at the model level (the
   engine refuses the family): a prefill of 8 rows with 1,500 seeded
   frames and 64 decode steps, exactly 2 K1 launches a decoder layer a
   step (self and cross) and no K3; one decode block of (q) and three
   decode steps of (r) are traced, with no synchronising call; and (s)
   training: qwen2-0.5b at full width, 12 of 24 layers, bf16, through
   ``repro_torch.launch.train.train``, batch 8 x seq 256, 20 steps: K3
   exactly 24 launches a step and no other kernel, every loss finite and
   the mean of the last 5 below the first, the loss of a held-out batch
   down by at least 0.01 from the initial weights, ms a step and peak
   memory, one step split into forward, backward and update and traced;
   then 10 steps with a checkpoint at step 10, restored into a fresh
   model and optimizer bit for bit, and the job resumed from it to step
   20 with the uninterrupted run's losses within 1e-6 (relative);
4b. serving on a (1, 2) ("data", "model") mesh of two ranks sharing the
   card over gloo (``repro_torch.launch.mesh.launch``; the kernels built
   above, the ranks load them), llama3.2-3b at full width: (t) at 8 of 28
   layers, f32 weights and KV under sub_operator, a prefill of 2 x 64
   and 16 greedy decode steps, whose tokens must equal the same weights
   unsharded on the card and whose logits must agree within 1e-4 of
   max|logit|, K1 and K3 launched on both ranks (12 query heads over 4 KV
   heads of 128, half of F); (u) at 2 of 28 layers, int8 weights and KV
   through the engine (``ctx=``) in continuous mode on (a)'s plan,
   sub_operator then operator_centric: the two executors' streams must be
   equal, the requests whose stream differs from the unsharded engine's
   (served once, on rank 0) are counted and every one replayed
   teacher-forced through the engine's chunk and slotted decode programs
   (``_flip_rule``, phase 4f's too), within 2e-2 of max|logit| at every
   step, K1 and K4 on
   both ranks; each executor's collective bytes per token step and TPOT
   are printed; (v) WA ``device_put`` on a (2, 1) mesh, W on rank 0 and A
   on rank 1, 8 layers: 4 staggered slotted steps equal colocated within
   1e-4 (K3 on W, K1 on A); every rank resets the launch counts before
   each run and reports them (phase 2 holds K1, K3 and K4 at one rank's
   shapes of these runs against their plain versions);
4c. training on meshes of two ranks sharing the card over gloo,
   qwen2-0.5b at full width, 8 of 24 layers, bf16, seeded weights, a
   global batch of 4 x 256 from ``launch.train``'s synthetic data,
   ``make_step(mode="train")``: (w) on (2, 1) under sub_operator+fsdp and
   (x) on (1, 2) under sub_operator, 4 steps each, every step's loss
   within 1e-2 (relative) and its grad norm within 5e-2 of the same
   weights' unsharded step on rank 0, K3 launched on every rank; (w)
   writes a checkpoint at step 2 (rank 0, the whole tree); then data
   domain 1 fails, the elastic controller re-meshes to (1, 1) (a new rank,
   ``runtime.elastic.remesh``), which restores it and runs steps 3-4
   within 1e-2 of (w)'s; per rank: ms a step, collective calls and bytes
   a step by site, peak memory, launches (phase 2 holds K3 with its
   gradient at one rank's shapes, 512 rows of F=4,864 and 1,024 rows of
   F=2,432, against its plain version);
4d. pipeline-parallel decode and the recurrent and enc-dec families on
   meshes of two ranks sharing the card over gloo: (z1) llama3.2-3b (int8
   weights and KV, bf16) at full width, 8 of 28 layers as two stages of 4
   on a (2, 1, 1) ("pod", "data", "model") mesh, B=8, 24 calls of
   ``make_step(pod_strategy="pp")``, each stage's logits held to the same
   stage loop run unsharded on its rank (the int8 rule: stored K/V bytes
   counted, 1e-4 of max|logit| until a flip, 2e-2 after; tokens exact),
   the pod axis carrying exactly B * d_model * 2 bytes a call a rank
   (``pp_hop``) and nothing else, K1 and K4 on both ranks, the wall a
   call; on (1, 2) under sub_operator in f32, (z2) mamba2-1.3b (4 of 48
   layers), (z3) recurrentgemma-9b (one superblock: 3 of 38; K1 at G=8
   hd 256 over the ring, K3 gelu at F=6,144) and (z4) whisper-medium
   (2 + 2 of 24 + 24, 1,500 frames; K1 at 8 heads a rank, self and
   cross), each a prefill of 2 x 64 and 16 greedy steps against the
   unsharded model on rank 0 (1e-4 of max|logit|, tokens exact), and
   (z2) through the engine on (a)'s plan with the unsharded engine's
   streams and host syncs (phase 2 holds these K1, K3 and K4 shapes);
4e. the recurrent and enc-dec families trained on meshes of two ranks
   sharing the card over gloo, full width, f32, seeded weights,
   ``launch.train``'s synthetic data, ``make_step(mode="train")`` under
   sub_operator+fsdp, each step's loss within 2e-5 and grad norm within
   2e-4 (relative) of the same steps unsharded on rank 0, the fsdp bytes
   a rank a step printed: (z5) mamba2-1.3b, 2 of 48 layers, on (2, 1),
   4 x 128, 3 steps (no port kernel: the SSD has none); (z6)
   recurrentgemma-9b, one superblock (3 of 38), on (1, 2), 2 x 128, 2
   steps (K3 gelu with a gradient on half of F a rank, the RG-LRU
   channels and the 256,000-row vocabulary cut over the model axis);
   (z7) whisper-medium, 2 + 2 of 24 + 24 layers, 1,500 frames, on (2, 1),
   2 x 64, 2 steps (no port kernel in training); and (z8)
   recurrentgemma-9b (one superblock, f32) through the engine on (1, 2),
   ``auto`` resolving to drain, on run (p)'s plan: streams and host syncs
   equal to the unsharded engine's, K1 over the ring and K3 gelu on both
   ranks (phase 2 holds K3 with its gradient at (z6)'s rank shape, 256
   rows of D=4,096 and F=6,144, f32);
4f. preemption, the tiered KV cache and KV budgets on meshes of two ranks
   sharing the card: qwen2-0.5b at full width, 2 of 24 layers, f32, hot
   window 64 and cold blocks of 16, through the engine, each run against
   the same engine and plan unsharded on rank 0 (streams equal, or held
   to the int8 rule: counted and every one replayed teacher-forced
   against the unsharded replay over a data row's slots within 2e-2 of
   max|logit|; preemptions, statuses, swap calls, demotions and peak
   bytes equal): (z9) an int4 cold tier under sub_operator+seqkv on (1,
   2) (K1 in partial mode over a rank's block of positions, merged across
   the ranks), run (h)'s plan through the chunk lane under a byte budget
   that preempts; (z10) int8 weights (K4) over an int8 cold tier under
   sub_operator on (2, 1), a priority plan whose restore lands on the
   other data row (the swap image moved rank to rank); (z11) the WA
   backend over an int8 cold tier on (1, 2), the swap pair on the A
   domain; (z12) run (f)'s chaos schedule on (1, 2) over 4 slots, its
   report equal to the unsharded one's;
5. time each kernel at the main path's shapes (K1 at B=8 over S=200 and
   at a long context of S=4096, bf16 and int8 KV, in partial mode at one
   shard of 48, the whole split attention of a layer at bucket 192 and the
   tiered attention of a layer at bucket 192, int8 and int4 cold: the
   resolve plus K1; K3 at 8, 32, 128 and 1,024 rows; K4 at 8 and 128 rows
   for the four projection shapes) against its bound, its plain version
   and PyTorch calls for the same function (K1: SDPA with ``enable_gqa``;
   K3: three matmuls and silu; K4: a bf16 matmul on dequantized weights
   and ``torch._int_mm``), K1, K3 and K4 at one mesh rank's shapes of
   phase 4b, the tiered append of a layer, a W->A->W hop
   pair of the WA backend against one colocated layer-step, and two spin
   kernels on one stream against one on each; then K1 at G=16 (S=200 and
   4096), K4 at the Llama projections and K3 at Llama-2-7B's FFN, an
   MoE layer's device time at qwen3-moe and phi3.5-moe widths split into
   router + dispatch, expert products and combine; K1 at run (p)'s shape
   (B=8, 16 heads on one KV head of 256, ring 256 and 2,048) against
   SDPA, K3 gelu at D=4096 F=12288 at 8 and 1,024 rows against three
   matmuls and gelu, and one SSD decode layer and one RG-LRU residual
   block at 8 rows (plain PyTorch, for the record); K1 at whisper's
   cross-attention (B=8, S=1,500) and internvl2's decode shape (B=8,
   S=200) against SDPA, K3 at internvl2's FFN at 8 and 384 rows against
   three matmuls and silu; K3 at the training shape (2,048 rows) against
   three matmuls and silu, and its plain-product backward; K3 at one rank's
   training shapes of phase 4c (512 rows of F=4,864, 1,024 rows of
   F=2,432) against three matmuls and silu; K1 at phase 4d's shapes (the
   ring at G=8 hd 256, whisper's 8 heads a rank over 1,500 frames and the
   self cache, a PP stage's) against SDPA and K3 gelu at F=6,144 against
   three matmuls and gelu; K3 gelu at (z6)'s training rank shape against
   three f32 matmuls and gelu, and K4 at a PP stage's projections
   (3072x3072, 3072x1024, 8192x3072; 8 rows) against a bf16 matmul on the
   dequantized weights; K1 at phase 4f's rank shapes (float mode over
   (z10)'s resolved image, partial mode over (z9)'s block) against SDPA.

It then prints the card (nvidia-smi name, power limit), a ``kernels`` JSON
line, and last the JSON result line. Without a GPU, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS = {torch.bfloat16: 989e12,       # dense tensor-core rates, 700 W
            torch.float32: 67e12,         # CUDA-core f32
            torch.int8: 1979e12}
L2_BYTES = 50 * 2 ** 20
REPLACES = {
    "flash_decode": "src/repro/kernels/flash_decode/flash_decode.py:84",
    # K1 in partial-statistics mode (split-KV decode), the same kernel
    "flash_decode_partial":
        "src/repro/kernels/flash_decode/flash_decode.py:84",
    "fused_ffn": "src/repro/kernels/fused_ffn/fused_ffn.py:43",
    "gemv_int8": "src/repro/kernels/gemv/gemv.py:42",
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() \
        else "not measured"


def require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2 / 5 inputs at the main path's shapes
# ---------------------------------------------------------------------------

K1_PAIRS = (("float32", "float32"), ("float32", "int8"),
            ("bfloat16", "bfloat16"), ("bfloat16", "int8"))


def k1_inputs(dev, B, S, pair=("bfloat16", "bfloat16"), lim=None, Hq=14,
              n_kv=2, hd=64, seed=0):
    """Decode attention inputs (q, k, v, mask, k_scale, v_scale, kv_limit)
    with q and K/V in the dtype ``pair``; K/V a bucket view of S positions
    of an S + 8 cache layer (strided rows, as the engine passes them).
    ``lim`` None: every row live to the end (kv_limit = S); else every row
    attends a position below ``lim`` (when lim > 0) and none at or past
    it."""
    from repro_torch.quant.int8 import quantize_kv
    g = torch.Generator(device=dev).manual_seed(seed)
    qdt, kvdt = (getattr(torch, n) for n in pair)
    q = torch.randn(B, Hq, hd, device=dev, generator=g).to(qdt)
    kf = torch.randn(B, n_kv, S + 8, hd, device=dev, generator=g)
    vf = torch.randn(B, n_kv, S + 8, hd, device=dev, generator=g)
    if kvdt == torch.int8:
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        ks, vs = ks[:, :, :S], vs[:, :, :S]
    else:
        k, v, ks, vs = kf.to(kvdt), vf.to(kvdt), None, None
    ar = torch.arange(S, device=dev)[None]
    if lim is None:
        lim = S
        pos = torch.full((B,), S - 1, device=dev)
    else:
        pos = torch.randint(0, max(1, min(lim, S)), (B,), device=dev,
                            generator=g)
    mask = (ar < pos[:, None] + 1) & (ar < lim)
    return (q, k[:, :, :S], v[:, :, :S], mask, ks, vs,
            torch.tensor(lim, dtype=torch.int32, device=dev))


def check_k1(args, lim):
    """Kernel against plain for one input set, normalised and partial:
    returns (max |d| of the normalised mode, max |d| of the partial mode,
    max |d| / tol, repeat identical). Tolerance 1e-5 * max(1, max|plain|)
    per output tensor (f32 online softmax in both, in another order);
    kv_limit <= 0 must give exactly 0 / (0, NEG_INF, 0)."""
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import (NEG_INF,
                                                      flash_decode_ref)
    err = {False: 0.0, True: 0.0}
    ratio = 0.0
    same = True
    for partial in (False, True):
        got = flash_decode(*args, partial_stats=partial)
        again = flash_decode(*args, partial_stats=partial)
        want = flash_decode_ref(*args, partial_stats=partial)
        if not partial:
            got, again, want = (got,), (again,), (want,)
        for a, b, w in zip(got, again, want):
            e = max_err(a, w)
            err[partial] = max(err[partial], e)
            ratio = max(ratio, e / (1e-5 * max(1.0, max_abs(w))))
            same = same and torch.equal(a, b)
        if lim <= 0:
            require(not got[0].any(), "K1 at kv_limit 0 is not 0")
            if partial:
                require(bool((got[1] == NEG_INF).all())
                        and not got[2].any(),
                        "K1 at kv_limit 0 is not (0, NEG_INF, 0)")
    return err[False], err[True], ratio, same


def split_inputs(dev, bucket, n, kv, ragged=True, B=8, Hq=14, n_kv=2,
                 hd=64, S=200, seed=0):
    """Split-KV attention inputs as the engine passes them: a bf16 query,
    one cache layer of S positions (bf16, or int8 with scales) cut to its
    first ``bucket`` positions as ``n`` shard views, the (B, bucket) mask,
    the global kv_limit on the device and the active rows. ``ragged``: live
    rows end at random positions in the first 5/8 of the bucket (mid-shard;
    with 4 shards the last one lies wholly past every row) and rows 6 and 7
    are inactive with cursors past every live row; else every row is live
    to the end of the bucket."""
    from repro_torch.kv.cache import batch_valid_mask, shard_view
    from repro_torch.quant.int8 import quantize_kv
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hq, hd, device=dev, generator=g).to(torch.bfloat16)
    kf = torch.randn(B, n_kv, S, hd, device=dev, generator=g)
    vf = torch.randn(B, n_kv, S, hd, device=dev, generator=g)
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        ks = vs = None
    if ragged:
        pos = torch.randint(0, bucket * 5 // 8, (B,), device=dev,
                            generator=g)
        active = torch.arange(B, device=dev) < 6
        pos = torch.where(active, pos, torch.full_like(pos, bucket - 1))
    else:
        pos = torch.full((B,), bucket - 1, device=dev)
        active = torch.ones(B, dtype=torch.bool, device=dev)
    mask = batch_valid_mask(bucket, pos)
    lim = (torch.where(active, pos, -1).max() + 1).to(torch.int32)
    views = shard_view(k, v, ks, vs, bucket, n)
    return (q, views[0], views[1], mask, views[2], views[3], lim), active


def split_plain(q, k, v, mask, ks, vs, lim):
    """The plain split attention on the tensors' own device: the plain K1
    version in partial mode per shard, then the LSE combine (the route
    ``split_flash_decode`` takes for CPU tensors)."""
    from repro_torch.kernels.flash_decode.combine import \
        combine_partial_stats
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kv.cache import shard_kv_limits
    B, _, n, Sb, _ = k.shape
    m3 = mask.reshape(B, n, Sb)
    lims = shard_kv_limits(lim, n, Sb)
    parts = [flash_decode_ref(q, k[:, :, s], v[:, :, s], m3[:, s],
                              None if ks is None else ks[:, :, s],
                              None if vs is None else vs[:, :, s], lims[s],
                              partial_stats=True) for s in range(n)]
    o, m, l = (torch.stack(t) for t in zip(*parts))
    return combine_partial_stats(o, m, l, axis=0).to(q.dtype)


def split_f64(q, k, v, mask, ks, vs, lim):
    """The function the split path computes, evaluated in float64 on the
    host: the masked single-query softmax over the whole bucket (the
    shards' views put back in order) under ``kv_limit``, int8 values and
    their scales dequantized in float64, the query in float64, scaled by
    1/sqrt(hd); each query head reads the KV head of its group. Returns
    (B, Hq, hd) float64. Rows with no live position are NaN (the caller
    compares live rows)."""
    B, n_kv, n, Sb, hd = k.shape
    S = n * Sb

    def deq(x, sc):
        x = x.detach().cpu().reshape(B, n_kv, S, hd).double()
        return x if sc is None else x * sc.detach().cpu().reshape(
            B, n_kv, S, 1).double()
    kd, vd = deq(k, ks), deq(v, vs)
    qd = q.detach().cpu().double().reshape(B, n_kv, -1, hd)
    s = torch.einsum("bkgh,bksh->bkgs", qd, kd) / math.sqrt(hd)
    live = mask.detach().cpu().reshape(B, S) & (
        torch.arange(S) < int(lim))[None]
    s = s.masked_fill(~live[:, None, None], -math.inf)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksh->bkgh", w, vd).reshape(B, -1, hd)


def k3_inputs(dev, R, seed=0, D=896, F=4864, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(R, D, device=dev, generator=g).to(dtype)
    ws = [(torch.randn(s, device=dev, generator=g) / math.sqrt(s[0]))
          .to(dtype) for s in ((D, F), (D, F), (F, D))]
    return (x, *ws), dict(act="silu")


def k4_inputs(dev, R, K, N, seed=0, unit=False):
    """K4's operands: int8 rows and weights with their f32 scales, or
    (``unit``) with scales of one, as a row-parallel layer on a mesh
    launches it (``common.linear_partial``)."""
    from repro_torch.quant.int8 import quantize_int8
    g = torch.Generator(device=dev).manual_seed(seed)
    xq = quantize_int8(torch.randn(R, K, device=dev, generator=g), axis=-1)
    wq = quantize_int8(torch.randn(K, N, device=dev, generator=g), axis=0)
    xs, ws = xq.scale, wq.scale.reshape(1, -1)
    if unit:
        xs, ws = torch.ones_like(xs), torch.ones_like(ws)
    return (xq.values, xs, wq.values, ws), {}


def max_err(got, want) -> float:
    if isinstance(got, tuple):
        return max(max_err(a, b) for a, b in zip(got, want))
    return float((got.float() - want.float()).abs().max())


def max_abs(t) -> float:
    if isinstance(t, tuple):
        return max(max_abs(a) for a in t)
    return float(t.float().abs().max())


def check_split(dev, errs):
    """Phase 2's split-KV attention as the engine runs it (B=8, Hq=14,
    n_kv=2, hd=64): one K1 launch per shard in partial mode (shard views
    of the cache, the mask sliced per shard, kv_limit element s of
    shard_kv_limits on the device), merged by the LSE combine, against a
    float64 evaluation of the same function on the host (``split_f64``);
    f32 before the final cast, active rows; Sb = 50 is no multiple of 16.
    The same function on CPU copies (the plain route, float32 on the
    host's CPU) is logged beside it and decides nothing: in one call it
    was the side that was off (ROADMAP Queue 3)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.attention import split_flash_decode
    for bucket in (64, 128, 192, 200):
        for n in (2, 4):
            for kv in ("bfloat16", "int8"):
                args, active = split_inputs(dev, bucket, n, kv,
                                            seed=bucket + n)
                reset_launch_counts()
                got = split_flash_decode(*args[:4], *args[4:6],
                                         kv_limit=args[6])
                launched = launch_counts()["flash_decode_partial"]
                again = split_flash_decode(*args[:4], *args[4:6],
                                           kv_limit=args[6])
                cpu = [None if t is None else t.cpu() for t in args]
                plain = split_flash_decode(*cpu[:6], kv_limit=cpu[6])
                act = active.cpu()
                want = split_f64(*args)[act]
                e = float((got.cpu()[act].double() - want).abs().max())
                e_plain = max_err(got.cpu()[act], plain[act])
                tol = 1e-5 * max(1.0, max_abs(want))
                same = torch.equal(got, again)
                errs["flash_decode_partial"] = max(
                    errs["flash_decode_partial"], e)
                log(f"  split attention bucket={bucket} shards={n} "
                    f"(Sb={bucket // n}) kv={kv}: {launched} partial "
                    f"launches, max|d| against float64 {e:.3g} (tol "
                    f"{tol:.3g}), against the plain route on the host's "
                    f"CPU {e_plain:.3g} (logged only), repeat "
                    f"identical={same}")
                require(launched == n, f"split attention launched "
                        f"{launched} partial K1 calls for {n} shards")
                require(e <= tol, f"split attention disagrees at bucket "
                        f"{bucket} shards {n} kv {kv}")
                require(same, f"split attention not deterministic at "
                        f"bucket {bucket} shards {n}")


def phase_compare(dev):
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    from repro_torch.kernels.gemv.ops import gemv_int8_q
    from repro_torch.kernels.gemv.ref import gemv_int8_ref
    errs = {"flash_decode": 0.0, "flash_decode_partial": 0.0,
            "fused_ffn": 0.0, "gemv_int8": 0.0}
    # K1: f32 online softmax in both, in a different summation order.
    # Every split count of the plan from one to many, kv_limit at 0, inside
    # a split, on a split edge and at S, and every row live to the end (as
    # timed in phase 5); then G*hd = 1024 (G=8, hd=128).
    from repro_torch.kernels.flash_decode.ops import decode_plan
    # Rows 1 to 8: the plan follows B, and the WA backend's micro-batches
    # launch K1 at 4 and 2 rows (8 slots at overlap 2 and 4).
    cases = [(S, B, pair, 14, 2, 64)
             for S in (1, 17, 64, 128, 200, 1000, 4096)
             for B in (1, 2, 4, 8) for pair in K1_PAIRS]
    cases += [(S, B, pair, 16, 2, 128) for S in (200, 4096)
              for B in (1, 2, 4, 8) for pair in K1_PAIRS]
    # the other configurations' groups at hd 128, at the engine runs'
    # bucket extents (64-200) among the S: G=16 (qwen3-moe, two launches
    # of 8 heads; run (l) at 8 rows), G=4 (phi3.5-moe and qwen3-8b; run
    # (m) at the overlap-2 micro-batches' 4 rows and phase 3's WA depths
    # at 2 and 1 in f32, so every row count and pair), G=3 (llama3.2-3b),
    # G=1 (llama2-7b; run (n) at 8 rows)
    buckets = (64, 128, 192, 200)
    cases += [(S, B, pair, 64, 4, 128)
              for S in (1, 17, *buckets, 1000, 4096)
              for B in (1, 8) for pair in K1_PAIRS[2:]]
    cases += [(S, B, pair, 32, 8, 128) for S in (1, *buckets, 4096)
              for B in (1, 2, 4, 8) for pair in K1_PAIRS]
    cases += [(S, B, pair, Hq, n_kv, 128) for S in (1, *buckets, 4096)
              for B in (1, 8) for Hq, n_kv in ((24, 8), (32, 32))
              for pair in K1_PAIRS[2:]]
    # one rank of phase 4b (llama3.2-3b on a 2-wide model axis: 12 query
    # heads over 4 KV heads of 128): run (t)'s decode (B=2, f32 q and KV,
    # the cache's 192 positions live up to 80, as phase 5 times it at 80)
    # and run (u)'s (B=8, bf16 q, int8 KV, the buckets 64-200)
    cases += [(S, B, pair, 12, 4, 128)
              for B, S_all, pairs in ((2, (1, 64, 80, 192), K1_PAIRS[:1]),
                                      (8, buckets, K1_PAIRS[3:]))
              for S in S_all for pair in pairs]
    for S, B, pair, Hq, n_kv, hd in cases:
        isz = torch.empty(0, dtype=getattr(torch, pair[1])).element_size()
        plan = decode_plan(B, n_kv, Hq // n_kv, S, hd, isz)
        edge = plan.split if plan.splits > 1 else S
        lims = sorted({0, max(1, plan.split // 2 + 3), edge, S})
        err = err_p = ratio = 0.0
        same = True
        for lim in lims + [None]:             # None: every row live to S
            args = k1_inputs(dev, B, S, pair, lim, Hq=Hq, n_kv=n_kv, hd=hd,
                             seed=S + B + (lim or 0))
            e, e_p, r, sm = check_k1(args, S if lim is None else lim)
            err, err_p = max(err, e), max(err_p, e_p)
            ratio, same = max(ratio, r), same and sm
        errs["flash_decode"] = max(errs["flash_decode"], err)
        errs["flash_decode_partial"] = max(errs["flash_decode_partial"],
                                           err_p)
        log(f"  K1 B={B} S={S} G={Hq // n_kv} hd={hd} q={pair[0]} "
            f"kv={pair[1]} ({plan.runs} x {plan.heads} heads, "
            f"{plan.splits} splits of {plan.split}), kv_limit {lims}: "
            f"max|d|={err:.3g} normalised, {err_p:.3g} partial, "
            f"max|d|/tol={ratio:.3g}, repeat identical={same}")
        require(ratio <= 1.0, f"K1 disagrees at B={B} S={S} {pair} hd={hd} "
                f"G={Hq // n_kv}")
        require(same, f"K1 not deterministic at B={B} S={S} {pair} "
                f"G={Hq // n_kv}")
    check_split(dev, errs)
    # K3: f32 through the intermediate in both; different summation order.
    # Rows across the 16/32/64-row tiles and the drain batch prefill's
    # 1,024 rows (8 x 128); D=200 F=700 divides no tile.
    # then the Llama-2-7B FFN (D=4096, F=11008) in bf16
    ffn_cases = [(D, F, dtype, R) for D, F in ((896, 4864), (200, 700))
                 for dtype in (torch.bfloat16, torch.float32)
                 for R in (1, 8, 16, 17, 32, 128, 1024)]
    ffn_cases += [(4096, 11008, torch.bfloat16, R) for R in (8, 32, 128,
                                                             1024)]
    # phase 4b's run (t): llama3.2-3b in f32 on one rank's half of F and
    # unsharded, at its decode rows (2), a 16-row tile and its prefill
    # rows (2 x 64 = 128)
    ffn_cases += [(3072, F, torch.float32, R) for F in (4096, 8192)
                  for R in (2, 16, 128)]
    for D, F, dtype, R in ffn_cases:
        args, _ = k3_inputs(dev, R, seed=R + D, D=D, F=F, dtype=dtype)
        for act in ("silu", "gelu"):
            got = fused_ffn(*args, act=act)
            want = fused_ffn_ref(*args, act=act)
            e, tol = max_err(got, want), 1e-4 * max(1, max_abs(want))
            same = torch.equal(fused_ffn(*args, act=act), got)
            errs["fused_ffn"] = max(errs["fused_ffn"], e)
            log(f"  K3 D={D} F={F} {str(dtype)[6:]} rows={R} act={act}: "
                f"max|d|={e:.3g} (tol {tol:.3g}), repeat identical={same}")
            require(e <= tol, f"K3 disagrees at D={D} rows={R} {dtype} "
                    f"{act}")
            require(same, f"K3 not deterministic at D={D} rows={R}")
    # K4: int32-exact accumulation, same f32 epilogue order: bit-exact.
    # K=100 is no multiple of the 16-row K chunk, N=130 none of 16 bytes;
    # 2 and 4 rows are the WA backend's micro-batches of 8 slots; then the
    # paper's Llama projections (q/o 4096x4096, gate/up 4096x11008, down
    # 11008x4096, llama3.2-3b gate/up 3072x8192) and phi3.5-moe's k/v
    # (4096x1024, run (m)) at 1-64 rows and a 128-token admission
    gemv_cases = [(K, N, R) for K in (100, 896, 4864)
                  for N in (128, 130, 896, 4864)
                  for R in (1, 2, 4, 8, 9, 17, 128)]
    gemv_cases = [(K, N, R, False) for K, N, R in gemv_cases]
    gemv_cases += [(K, N, R, False) for K, N in ((4096, 4096), (4096, 1024),
                                                 (4096, 11008), (11008, 4096),
                                                 (3072, 8192))
                   for R in (1, 2, 4, 8, 16, 32, 64, 128)]
    # one rank of phase 4b's run (u) (llama3.2-3b int8 on a 2-wide model
    # axis): wq 3072x1536, wk/wv 3072x512, gate/up 3072x4096 (real
    # scales) and the row-parallel wo 1536x3072 and w_down 4096x3072 (unit
    # scales: the rank's integer accumulator, scaled after the reduction),
    # each both ways, at its decode rows (8) and a prefill chunk (32)
    gemv_cases += [(K, N, R, unit)
                   for K, N in ((3072, 1536), (3072, 512), (1536, 3072),
                                (3072, 4096), (4096, 3072))
                   for R in (8, 32) for unit in (False, True)]
    for K, N, R, unit in gemv_cases:
        args, _ = k4_inputs(dev, R, K, N, seed=K + N + R, unit=unit)
        got, want = gemv_int8_q(*args), gemv_int8_ref(*args)
        e = max_err(got, want)
        exact = torch.equal(got, want)
        same = torch.equal(gemv_int8_q(*args), got)
        errs["gemv_int8"] = max(errs["gemv_int8"], e)
        how = " unit scales" if unit else ""
        log(f"  K4 K={K} N={N} rows={R}{how}: max|d|={e:.3g} (tol 0, "
            f"exact={exact}, repeat identical={same})")
        require(exact, f"K4 not exact at {K}x{N} rows={R}{how}")
        require(same, f"K4 not deterministic at {K}x{N} rows={R}{how}")
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------------------
# phase 3: full-width model, 2 layers, f32, CPU vs CUDA
# ---------------------------------------------------------------------------

CACHE_BUFFERS = ("k", "v", "k_scale", "v_scale", "hot_k", "hot_v")


def clone_cache(c):
    import dataclasses
    return dataclasses.replace(c, **{
        f: None if getattr(c, f) is None else getattr(c, f).clone()
        for f in CACHE_BUFFERS + ("length",)})


def fill_cache(c, g):
    """Seeded bytes in every buffer of cache ``c`` (CPU generator ``g``):
    int8 over its whole range, scales in [0.01, 1.01), floats normal."""
    for f in CACHE_BUFFERS:
        t = getattr(c, f)
        if t is None:
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-128, 128, t.shape, generator=g))
        elif t.shape[-1] == 1:
            t.copy_(torch.rand(t.shape, generator=g) + 0.01)
        else:
            t.copy_(torch.randn(t.shape, generator=g))
    return c


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def phase_model_parity():
    from repro_torch.configs.registry import get_config
    from repro_torch.interop import to_device
    from repro_torch.models.registry import build_model
    cfg = get_config("qwen2-0.5b").replace(n_layers=2, dtype="float32")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16),
                                            dtype=np.int64))
    cpu_params = build_model(cfg, device="cpu").init(0)
    res = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(cpu_params, api.device)
        caches = api.init_caches(8, 48)
        first = []
        for slot in range(8):
            single, lg = api.prefill(params, prompts[slot:slot + 1]
                                     .to(api.device))
            caches = api.write_slot(caches, single, slot)
            first.append(lg[0, -1])
        tok = torch.stack(first).argmax(-1).to(torch.int32)
        pos = torch.full((8,), 16, dtype=torch.int32, device=api.device)
        act = torch.ones(8, dtype=torch.bool, device=api.device)
        saved, split_c, drain_c = (clone_cache(caches) for _ in range(3))

        def steps(step, c):
            """8 greedy steps of ``step(c, tokens, positions)`` from the
            admitted state -> (logits (8,B,V) on the CPU, tokens (8,B))."""
            logits, toks = [], []
            t, p = tok, pos
            for _ in range(8):
                c, lg = step(c, t, p)
                logits.append(lg[:, 0].float().cpu())
                t = lg[:, 0].argmax(-1).to(torch.int32)
                toks.append(t.cpu())
                p = p + 1
            return torch.stack(logits), torch.stack(toks)

        slotted = steps(lambda c, t, p: api.decode_slotted(params, c, t, p,
                                                           act), caches)
        blk = api.decode_block(
            params, saved, tok, pos, act,
            torch.full((8,), 8, dtype=torch.int32, device=api.device),
            torch.full((8,), -1, dtype=torch.int32, device=api.device),
            block_size=8, kv_bucket=32)
        split = steps(lambda c, t, p: api.decode_slotted(
            params, c, t, p, act, kv_shards=4), split_c)
        res[d] = (*slotted, blk[1].cpu(), *split)
        if d == "cuda":
            # the drain path's shared-cursor step (cache.length = 16 for
            # every row) against slotted decode at that one cursor
            drain = steps(lambda c, t, p: api.decode(params, c, t), drain_c)
            d_rel = rel_err(drain[0], slotted[0])
            d_same = torch.equal(drain[1], slotted[1])
    lc, lg = res["cpu"][0], res["cuda"][0]
    rel = rel_err(lg, lc)
    s_rel = rel_err(res["cuda"][3], res["cpu"][3])
    same_steps = torch.equal(res["cpu"][1], res["cuda"][1])
    same_block = torch.equal(res["cpu"][2], res["cuda"][2])
    block_is_steps = torch.equal(res["cuda"][2], res["cuda"][1])
    same_split = torch.equal(res["cpu"][4], res["cuda"][4])
    log(f"  2-layer full-width f32: max|dlogit|/max|logit| = {rel:.3g} "
        f"(tol 1e-3); tokens equal: slotted={same_steps} "
        f"block={same_block}; block == slotted steps: {block_is_steps}")
    log(f"  split-KV decode, 4 shards of 12: cpu vs cuda "
        f"max|dlogit|/max|logit| = {s_rel:.3g} (tol 1e-3), tokens equal="
        f"{same_split}")
    log(f"  shared-cursor decode_step vs decode_step_slotted on cuda: "
        f"max|dlogit|/max|logit| = {d_rel:.3g} (tol 1e-3), tokens equal="
        f"{d_same}")
    require(np.isfinite(rel) and rel <= 1e-3, "model logits disagree")
    require(same_steps and same_block and block_is_steps,
            "model tokens disagree")
    require(np.isfinite(s_rel) and s_rel <= 1e-3 and same_split,
            "split-KV decode disagrees between cpu and cuda")
    require(np.isfinite(d_rel) and d_rel <= 1e-3 and d_same,
            "decode_step disagrees with decode_step_slotted")


def phase_swap_pair():
    """The preemption swap pair on the card against the CPU, on one cache
    of the 2-layer full-width model (8 slots, extent 200) filled with the
    same seeded bytes, float32 and int8 KV: the export image of slot 1,
    then the cache after importing it into slot 5 at valid_len 1, 37 and
    200, must equal the CPU's bit for bit; slot 5 keeps its own bytes at
    and past valid_len; and the 4-shard views of the restored layer (the
    split-KV read, shards of 50) equal the CPU's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kv.cache import (export_slot_kv, import_slot_kv,
                                      shard_view)
    from repro_torch.models.registry import build_model
    names = ("k", "v", "k_scale", "v_scale")
    for kv in ("float32", "int8"):
        cfg = get_config("qwen2-0.5b").replace(n_layers=2, dtype="float32",
                                               kv_dtype=kv)
        g = torch.Generator().manual_seed(0)
        base = build_model(cfg, device="cpu").init_caches(8, 200)
        for n in names:
            t = getattr(base, n)
            if t is None:
                continue
            t.copy_(torch.randint(-127, 127, t.shape, generator=g)
                    if t.dtype == torch.int8
                    else torch.rand(t.shape, generator=g) + 0.01)
        for valid in (1, 37, 200):
            res = {}
            for d in ("cpu", "cuda"):
                c = build_model(cfg, device=d).init_caches(8, 200)
                for n in names:
                    if getattr(c, n) is not None:
                        getattr(c, n).copy_(getattr(base, n))
                image = tuple(None if a is None else a.cpu()
                              for a in export_slot_kv(c, 1))
                c = import_slot_kv(c, image, 5, valid)
                views = shard_view(*c.layer(1), 200, 4)
                res[d] = [t.cpu() for t in image[:4] + tuple(
                    getattr(c, n) for n in names) + views
                          if t is not None]
                if d == "cuda":
                    k = c.k.cpu()
            same = all(torch.equal(a, b)
                       for a, b in zip(res["cpu"], res["cuda"]))
            kept = torch.equal(k[:, 5, :, valid:], base.k[:, 5, :, valid:])
            moved = torch.equal(k[:, 5, :, :valid], base.k[:, 1, :, :valid])
            log(f"  swap pair, kv={kv}, slot 1 -> 5 at valid_len {valid}: "
                f"cuda == cpu bit for bit (image, cache, 4-shard views): "
                f"{same}; positions < valid_len restored: {moved}; "
                f">= valid_len kept: {kept}")
            require(same and kept and moved,
                    f"swap pair disagrees at kv={kv} valid_len={valid}")


# the tier geometry of run (g): hot window 64, demotion blocks of 16, a ring
# of 80 slots; run (h): hot window 32, blocks of 16, int8 cold
G_TIERS = dict(hot_window=64, kv_cold_block=16)
H_TIERS = dict(hot_window=32, kv_cold_block=16, kv_cold_dtype="int8")


def phase_tiered_cache():
    """The tiered cache functions on the card against the CPU, bit for bit,
    on one layer of the 2-layer full-width cache (8 slots, extent 200, run
    (g)'s ring of 80) filled with the same seeded bytes, int8 and int4
    cold: 19 decode appends at ragged cursors (rows 6 and 7 inactive, the
    ring wrapping), the resolved image over buckets 192 and 200 and its
    4-shard views; a 32-wide chunk at 64 whose residue wraps the ring
    (ring slots 64..79 and 0..15) and a 128-wide full-width chunk with 100
    valid, each with the chunk program's hot image from the pre-write ring
    and the slot's cold image after the write; then the export of slot 1
    and its import into slot 5 at valid_len 1, 37 and 200."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kv import cache as kc
    from repro_torch.models.registry import build_model
    for cold in ("int8", "int4"):
        cfg = get_config("qwen2-0.5b").replace(n_layers=2, dtype="float32",
                                               kv_cold_dtype=cold, **G_TIERS)
        g = torch.Generator().manual_seed(0)
        base = fill_cache(build_model(cfg, device="cpu").init_caches(8, 200),
                          g)
        B, n_kv, hd = 8, cfg.n_kv_heads, cfg.head_dim
        start_pos = torch.arange(B, dtype=torch.int32) * 19
        appends = [(torch.randn(B, n_kv, hd, generator=g),
                    torch.randn(B, n_kv, hd, generator=g),
                    start_pos + t, (torch.arange(B) < 6) & (t % 7 != 5))
                   for t in range(19)]
        chunks = [(2, 64, 32, torch.randn(n_kv, 32, hd, generator=g),
                   torch.randn(n_kv, 32, hd, generator=g)),
                  (3, 0, 100, torch.randn(n_kv, 128, hd, generator=g),
                   torch.randn(n_kv, 128, hd, generator=g))]
        counts = start_pos + 19
        res = {}
        for d in ("cpu", "cuda"):
            c = build_model(cfg, device=d).init_caches(8, 200)
            for f in CACHE_BUFFERS:
                if getattr(c, f) is not None:
                    getattr(c, f).copy_(getattr(base, f))
            lay = c.layer(1)
            out = []

            def snap():
                return [t.clone() for t in lay if t is not None]

            for kn, vn, pos, act in appends:
                kc.layer_append_tiered(*lay, kn.to(d), vn.to(d), pos.to(d),
                                       cold, act.to(d))
            out += snap()
            geom = (cfg.hot_window, cfg.kv_cold_block, cold)
            for bucket in (192, 200):
                out += kc.layer_read_tiered(*lay, counts.to(d), bucket,
                                            *geom, dtype=torch.float32)
                out += kc.layer_read_tiered_shards(
                    *lay, counts.to(d), bucket, 4, *geom,
                    dtype=torch.float32)
            for slot, start, valid, kn, vn in chunks:
                kn, vn = kn.to(d), vn.to(d)
                out += kc.chunk_hot_image(lay[4], lay[5], kn, vn, slot,
                                          start, valid, 200,
                                          dtype=torch.float32)
                kc.layer_write_chunk_tiered(*lay, kn, vn, slot, start, valid,
                                            cold)
                out += snap()
                out += kc.layer_read_slot_cold(*lay[:4], slot, cold,
                                               dtype=torch.float32)
            image = tuple(a.cpu() for a in kc.export_slot_kv(c, 1))
            out += image
            for valid in (1, 37, 200):
                r = kc.import_slot_kv(clone_cache(c), image, 5, valid)
                out += [getattr(r, f) for f in CACHE_BUFFERS]
            res[d] = [t.cpu() for t in out if t is not None]
        same = [torch.equal(a, b) for a, b in zip(res["cpu"], res["cuda"])]
        log(f"  tiered cache, cold={cold} (ring 80, extent 200): appends, "
            f"resolved reads (buckets 192/200, 4 shards), hot images, chunk "
            f"writes (one wrapping the ring), slot cold images, export and "
            f"import at valid_len 1/37/200: {sum(same)} of {len(same)} "
            f"tensors cuda == cpu bit for bit")
        require(all(same) and len(same) == len(res["cuda"]),
                f"tiered cache functions disagree between cpu and cuda "
                f"(cold={cold})")


def phase_model_parity_tiered():
    """The model over a tiered cache at full width, 2 layers, f32, CPU
    against CUDA, int8 and int4 cold, with hot window 8 and blocks of 4
    (ring 12) so the boundary moves inside prefill and decode: 8 slots
    admitted by two 8-wide chunks of a 16-token prompt (chunked prefill
    across the boundaries 4, 8 and 12), 8 slotted decode steps at bucket
    32, the decode block (T=8, bucket 32) from the admitted state and 8
    split-KV decode steps over 4 shards of 12: equal tokens, logits within
    1e-3 of max|logit|."""
    from repro_torch.configs.registry import get_config
    from repro_torch.interop import to_device
    from repro_torch.models.registry import build_model
    from repro_torch.quant.int4 import unpack_int4
    rng = np.random.default_rng(1)
    for cold in ("int8", "int4"):
        cfg = get_config("qwen2-0.5b").replace(
            n_layers=2, dtype="float32", hot_window=8, kv_cold_block=4,
            kv_cold_dtype=cold)
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16),
                                                dtype=np.int64))
        cpu_params = build_model(cfg, device="cpu").init(0)
        res = {}
        for d in ("cpu", "cuda"):
            api = build_model(cfg, device=d)
            params = to_device(cpu_params, api.device)
            caches = api.init_caches(8, 48)
            chunk_lg = []
            for slot in range(8):
                for start in (0, 8):
                    caches, lg = api.prefill_chunk(
                        params, caches, prompts[slot:slot + 1,
                                                start:start + 8].to(d),
                        slot, start, 8)
                    chunk_lg.append(lg[0, -1].float().cpu())
            tok = torch.stack(chunk_lg[1::2]).argmax(-1).to(torch.int32) \
                .to(d)
            pos = torch.full((8,), 16, dtype=torch.int32, device=d)
            act = torch.ones(8, dtype=torch.bool, device=d)
            block_c, split_c = clone_cache(caches), clone_cache(caches)

            def steps(**kw):
                c, t, p = kw.pop("c"), tok, pos
                logits, toks = [], []
                for _ in range(8):
                    c, lg = api.decode_slotted(params, c, t, p, act, **kw)
                    logits.append(lg[:, 0].float().cpu())
                    t = lg[:, 0].argmax(-1).to(torch.int32)
                    toks.append(t.cpu())
                    p = p + 1
                return torch.stack(logits), torch.stack(toks), c

            slotted = steps(c=caches, kv_bucket=32)
            blk = api.decode_block(
                params, block_c, tok, pos, act,
                torch.full((8,), 8, dtype=torch.int32, device=d),
                torch.full((8,), -1, dtype=torch.int32, device=d),
                block_size=8, kv_bucket=32)
            split = steps(c=split_c, kv_shards=4)
            res[d] = (torch.stack(chunk_lg), slotted, blk[1].cpu(), split)
        cpu, cuda = res["cpu"], res["cuda"]
        flips = 0
        for a, b in ((cpu[1][2].k, cuda[1][2].k), (cpu[1][2].v,
                                                   cuda[1][2].v)):
            a, b = a.cpu(), b.cpu()
            if cold == "int4":
                a, b = unpack_int4(a), unpack_int4(b)
            flips += int((a != b).sum())
        rels = {"chunked prefill": rel_err(cuda[0], cpu[0]),
                "slotted decode": rel_err(cuda[1][0], cpu[1][0]),
                "split decode, 4 shards": rel_err(cuda[3][0], cpu[3][0])}
        same = {"slotted": torch.equal(cpu[1][1], cuda[1][1]),
                "block": torch.equal(cpu[2], cuda[2]),
                "block == slotted steps": torch.equal(cuda[2], cuda[1][1]),
                "split": torch.equal(cpu[3][1], cuda[3][1])}
        log(f"  tiered model, cold={cold} (hot 8, block 4), 2-layer "
            f"full-width f32, cpu vs cuda: max|dlogit|/max|logit| "
            + ", ".join(f"{k} {v:.3g}" for k, v in rels.items())
            + f" (tol 1e-3); tokens equal: {same}; cold-tier steps that "
            f"differ after slotted decode: {flips}")
        require(all(np.isfinite(v) and v <= 1e-3 for v in rels.values()),
                f"tiered model logits disagree (cold={cold})")
        require(all(same.values()), f"tiered model tokens disagree "
                f"(cold={cold})")


@contextlib.contextmanager
def recorded_act_quant(rows, replay=None):
    """Append a host copy of every activation quantization that K4
    multiplies (values, scales; once per row for the linears that share an
    input) to ``rows``, in call order. With ``replay`` (the records of the
    same programs on the card), each call returns the card's quantization
    instead of its own, which must pair up with it and be at most one int8
    step from it everywhere.

    int8 weights: the CPU and the card sum in different orders, so an f32
    activation a last bit apart can round to the neighbouring int8 step,
    and later layers carry the change on (thousands of flips and 2e-2 of
    max|logit| over 2 layers at full width). Replaying the card's rows on
    the CPU holds K4 and every other op to the 1e-3 bound on the same int8
    inputs; the flips are counted (``int8_flips``)."""
    from repro_torch.kernels.gemv import ops
    from repro_torch.quant.int8 import QuantizedTensor
    quantize = ops.quantize_int8

    def rec(x, axis):
        xq = quantize(x, axis=axis)
        rows.append((xq.values.cpu(), xq.scale.cpu()))
        if replay is None:
            return xq
        require(len(rows) <= len(replay), "the CPU quantizes more "
                "activations than the card")
        v, sc = replay[len(rows) - 1]
        require(v.shape == xq.values.shape and int(
            (v.int() - rows[-1][0].int()).abs().max()) <= 1,
            "a CPU activation row is more than one int8 step from the "
            "card's")
        return QuantizedTensor(v.to(x.device), sc.to(x.device))

    ops.quantize_int8 = rec
    try:
        yield
    finally:
        ops.quantize_int8 = quantize


def int8_flips(a, b) -> int:
    """Elements that differ between two records of ``recorded_act_quant``;
    the records must pair up call for call."""
    require(len(a) == len(b), "activations recorded on CPU and CUDA do "
            "not pair up")
    return sum(int((x[0] != y[0]).sum()) for x, y in zip(a, b))


# the WA programs of phase 3: (label, config overrides, a_shards)
WA_CACHES = (("flat f32 KV", {}, 1), ("int8 KV", dict(kv_dtype="int8"), 1),
             ("int8 weights, int8 KV",
              dict(weight_int8=True, kv_dtype="int8"), 1),
             ("f32 KV, 4 shards", {}, 4),
             ("tiered int4 cold (hot 8, block 4)",
              dict(hot_window=8, kv_cold_block=4, kv_cold_dtype="int4"), 1))


def phase_wa_parity():
    """The WA programs (``core/wa.py``) at full width, 2 layers, f32, CPU
    against CUDA, over the caches of ``WA_CACHES``: 8 slots admitted by
    ``prefill_chunk`` (two 8-wide chunks of a 16-token prompt), then at
    overlap 1, 2 and 4: 4 ``decode_step_slotted`` steps at bucket 32 (row
    5 idle in the first) and one ``decode_block`` (T=8, bucket 32) from the
    admitted state. Equal tokens, logits within 1e-3 of max|logit| (with
    int8 weights, the CPU multiplies the card's int8 activation rows:
    ``recorded_act_quant``). On CUDA, also the largest
    difference between WA at depth 1 and the colocated programs on the
    same state (the same kernels in the same order on two streams:
    expected 0)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.wa import WADisaggregated
    from repro_torch.interop import to_device
    from repro_torch.models.registry import build_model
    rng = np.random.default_rng(2)
    for label, over, shards in WA_CACHES:
        cfg = get_config("qwen2-0.5b").replace(n_layers=2, dtype="float32",
                                               **over)
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 16),
                                                dtype=np.int64))
        cpu_params = build_model(cfg, device="cpu").init(0)
        res, vs_colocated, acts = {}, {}, {}
        for d in ("cuda", "cpu"):
            acts[d] = rec = {}
            card = acts["cuda"] if d == "cpu" else {}
            api = build_model(cfg, device=d)
            params = to_device(cpu_params, api.device)
            was = {D: WADisaggregated(cfg, d, overlap=D, a_shards=shards)
                   for D in (1, 2, 4)}
            caches = api.init_caches(8, 48)
            chunk_lg = []
            with recorded_act_quant(rec.setdefault("chunk", []),
                                    card.get("chunk")):
                for slot in range(8):
                    for start in (0, 8):
                        caches, lg = was[1].prefill_chunk(
                            params, caches,
                            prompts[slot:slot + 1, start:start + 8].to(d),
                            slot, start, 8)
                        chunk_lg.append(lg[0, -1].float().cpu())
            tok = torch.stack(chunk_lg[1::2]).argmax(-1).to(torch.int32) \
                .to(d)
            pos = torch.full((8,), 16, dtype=torch.int32, device=d)

            def steps(fn, c):
                logits, toks = [], []
                t, p = tok, pos
                for i in range(4):
                    act = torch.ones(8, dtype=torch.bool, device=d)
                    if i == 0:
                        act[5] = False
                    c, lg = fn(params, c, t, p, act, kv_bucket=32)
                    logits.append(lg[:, 0].float().cpu())
                    t = torch.where(act, lg[:, 0].argmax(-1).to(torch.int32),
                                    0)
                    toks.append(t.cpu())
                    p = p + act.to(torch.int32)
                return torch.stack(logits), torch.stack(toks)

            out = {}
            for D, wa in was.items():
                blk = wa.decode_block(
                    params, clone_cache(caches), tok, pos,
                    torch.ones(8, dtype=torch.bool, device=d),
                    torch.full((8,), 8, dtype=torch.int32, device=d),
                    torch.full((8,), -1, dtype=torch.int32, device=d),
                    block_size=8, kv_bucket=32)
                with recorded_act_quant(rec.setdefault(f"steps d{D}", []),
                                        card.get(f"steps d{D}")):
                    stepped = steps(wa.decode_step_slotted,
                                    clone_cache(caches))
                out[D] = (*stepped, blk[1].cpu())
            res[d] = (torch.stack(chunk_lg), out)
            if d == "cuda":
                co = steps(lambda *a, **k: api.decode_slotted(
                    *a, **k, kv_shards=shards), clone_cache(caches))
                vs_colocated = {
                    "step logits": float((out[1][0] - co[0]).abs().max()),
                    "tokens equal": torch.equal(out[1][1], co[1])}
        cpu, cuda = res["cpu"], res["cuda"]
        # the CPU's own K4 activation steps that differ from the card's
        flips = {"chunk": int8_flips(acts["cpu"]["chunk"],
                                     acts["cuda"]["chunk"])}
        rels = {"chunk": rel_err(cuda[0], cpu[0])}
        same, depths = {}, {}
        for D in (1, 2, 4):
            key = f"steps d{D}"
            flips[key] = int8_flips(acts["cpu"][key], acts["cuda"][key])
            rels[key] = rel_err(cuda[1][D][0], cpu[1][D][0])
            same[f"d{D}"] = (torch.equal(cuda[1][D][1], cpu[1][D][1])
                             and torch.equal(cuda[1][D][2], cpu[1][D][2]))
            # not a gate: K1's split plan follows the micro-batch's rows
            depths[f"d{D}"] = (torch.equal(cuda[1][D][1], cuda[1][1][1])
                               and torch.equal(cuda[1][D][2], cuda[1][1][2]))
        log(f"  WA programs, {label}, 2-layer full-width f32, cpu vs cuda: "
            f"max|dlogit|/max|logit| " + ", ".join(
                f"{k} {v:.3g}" for k, v in rels.items())
            + f" (tol 1e-3); CPU K4 activation steps one off the card's "
            f"(the card's replayed): {flips}; tokens equal: {same}; "
            f"cuda tokens equal to depth 1's: {depths}; WA depth 1 vs "
            f"colocated on cuda: "
            f"max|dlogit| {vs_colocated['step logits']:.3g}, tokens equal "
            f"{vs_colocated['tokens equal']}")
        require(all(np.isfinite(v) and v <= 1e-3 for v in rels.values()),
                f"WA logits disagree ({label})")
        require(all(same.values()), f"WA tokens disagree ({label})")
        require(vs_colocated["tokens equal"],
                f"WA depth 1 tokens differ from colocated ({label})")


@contextlib.contextmanager
def recorded_routing(rows):
    """Append a host copy of the (T, K) expert ids of every MoE layer's
    routing to ``rows``, in call order."""
    from repro_torch.models import moe
    route = moe.route

    def rec(p, xf, k):
        out = route(p, xf, k)
        rows.append(out[2].cpu())
        return out

    moe.route = rec
    try:
        yield
    finally:
        moe.route = route


def router_flips(a, b) -> int:
    """Token rows whose top-k expert set differs between two records of
    ``recorded_routing``, which must pair up call for call."""
    require(len(a) == len(b) and all(x.shape == y.shape
                                     for x, y in zip(a, b)),
            "routings recorded on CPU and CUDA do not pair up")
    return sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))


def phase_moe_parity():
    """The MoE family at full phi3.5-moe width (d 4096, 32/8 heads of 128,
    16 experts x 6400, top-2, LayerNorm), depth cut to 2 layers, f32, the
    same seeded weights on the CPU (plain versions) and the card (made on
    the card from a seed, copied to the CPU): 8 slots admitted by 8-wide
    chunks (``prefill_chunk``), then from the admitted state 4 slotted
    decode steps (bucket 32), the decode block (T=4), 4 split-KV steps
    over 4 shards of 12, and 4 steps of the WA program at overlap 1, 2
    and 4. Tokens equal; logits within
    1e-3 of max|logit|, or 2e-2 in a program whose routing (recorded on
    both sides, chunks included) picked another top-k set for some token
    (the CPU and cuBLAS sum the f32 router product in other orders). On
    the card, WA at depth 1 gives the colocated step's logits bit for
    bit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.wa import WADisaggregated
    from repro_torch.interop import to_device
    from repro_torch.models.registry import build_model
    cfg = get_config("phi3.5-moe-42b-a6.6b").replace(n_layers=2,
                                                     dtype="float32")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, 8), dtype=np.int64))
    t0 = time.monotonic()
    cpu_params = to_device(build_model(cfg).init(0), "cpu")
    log(f"  MoE parity: seeded f32 weights of 2 phi3.5-moe layers made on "
        f"the card and copied to the CPU in {time.monotonic() - t0:.1f}s")
    res, routes, walls = {}, {}, {}
    for d in ("cuda", "cpu"):
        t0 = time.monotonic()
        routes[d] = rec = {}
        api = build_model(cfg, device=d)
        params = to_device(cpu_params, api.device)
        caches = api.init_caches(8, 48)
        chunk_lg = []
        with recorded_routing(rec.setdefault("chunk", [])):
            for slot in range(8):
                caches, lg = api.prefill_chunk(
                    params, caches, prompts[slot:slot + 1].to(d), slot, 0, 8)
                chunk_lg.append(lg[0, -1].float().cpu())
        tok = torch.stack(chunk_lg).argmax(-1).to(torch.int32).to(d)
        pos = torch.full((8,), 8, dtype=torch.int32, device=d)
        act = torch.ones(8, dtype=torch.bool, device=d)

        def steps(fn, key, **kw):
            c, t, p = clone_cache(caches), tok, pos
            logits, toks = [], []
            with recorded_routing(rec.setdefault(key, [])):
                for _ in range(4):
                    c, lg = fn(params, c, t, p, act, **kw)
                    logits.append(lg[:, 0].float().cpu())
                    t = lg[:, 0].argmax(-1).to(torch.int32)
                    toks.append(t.cpu())
                    p = p + 1
            return torch.stack(logits), torch.stack(toks)

        def block(impl, key):
            with recorded_routing(rec.setdefault(key, [])):
                return impl(params, clone_cache(caches), tok, pos, act,
                            torch.full((8,), 4, dtype=torch.int32, device=d),
                            torch.full((8,), -1, dtype=torch.int32,
                                       device=d),
                            block_size=4, kv_bucket=32)[1].cpu()

        out = {"slotted": steps(api.decode_slotted, "slotted", kv_bucket=32),
               "block": block(api.decode_block, "block"),
               "split": steps(api.decode_slotted, "split", kv_shards=4)}
        for D in (1, 2, 4):
            wa = WADisaggregated(cfg, d, overlap=D)
            out[f"wa d{D}"] = steps(wa.decode_step_slotted, f"wa d{D}",
                                    kv_bucket=32)
        res[d] = (torch.stack(chunk_lg), out)
        walls[d] = time.monotonic() - t0
        del api, params, caches
    del cpu_params
    torch.cuda.empty_cache()
    cpu, cuda = res["cpu"], res["cuda"]
    flips = {k: router_flips(routes["cpu"][k], routes["cuda"][k])
             for k in routes["cpu"]}
    rels, same = {"chunk": rel_err(cuda[0], cpu[0])}, {}
    ok = rels["chunk"] <= (1e-3 if flips["chunk"] == 0 else 2e-2)
    for k, (lg_cpu, tk_cpu) in ((k, v) for k, v in cpu[1].items()
                                if k != "block"):
        rels[k] = rel_err(cuda[1][k][0], lg_cpu)
        tol = 1e-3 if flips["chunk"] + flips[k] == 0 else 2e-2
        ok = ok and np.isfinite(rels[k]) and rels[k] <= tol
        same[k] = torch.equal(cuda[1][k][1], tk_cpu)
    same["block"] = torch.equal(cuda[1]["block"], cpu[1]["block"])
    same["block == slotted steps"] = torch.equal(cuda[1]["block"],
                                                 cuda[1]["slotted"][1])
    d1_exact = torch.equal(cuda[1]["wa d1"][0], cuda[1]["slotted"][0])
    log(f"  MoE (phi3.5-moe width, 2 layers, f32), cpu vs cuda: "
        f"max|dlogit|/max|logit| " + ", ".join(
            f"{k} {v:.3g}" for k, v in rels.items())
        + f" (tol 1e-3, 2e-2 after a router flip); router flips (token "
        f"rows with another top-k set): {flips}; tokens equal: {same}; WA "
        f"depth 1 logits == colocated on cuda bit for bit: {d1_exact}; "
        f"wall cuda {walls['cuda']:.1f}s, cpu {walls['cpu']:.1f}s")
    require(ok, "MoE logits disagree between cpu and cuda")
    require(all(same.values()), "MoE tokens disagree")
    require(d1_exact, "MoE: WA depth 1 differs from colocated on cuda")


# ---------------------------------------------------------------------------
# phase 4: the engine at full qwen2-0.5b
# ---------------------------------------------------------------------------

# runs (b), (f), (h), (j) and (k), the WA block walls and the block walls
# of the KV layouts at a third of qwen2-0.5b's 24 layers (half until phase
# 4e joined the script; the block walls at all 24): their checks compare
# runs of one depth with each other or with their plan's host syncs
SHORT = dict(n_layers=8)
# runs (e) and (g) at a third (8 layers) since the mesh phase 4b joined the
# script: their checks are their plan's host syncs, equal to (a)'s at any
# depth, and no stream is compared across depths
SHORTER = dict(n_layers=8)
RUNS = {
    # name: (config overrides, engine kwargs, n_requests, max_new, kernels)
    "a_bf16_chunked_T8": (
        {}, dict(block_size=8, kv_bucket_chunk=64, prefill_chunk=32,
                 max_new_cap=72), 12, 64, ("flash_decode", "fused_ffn")),
    # (b), (k) and (j) (the int8 runs, their streams compared with each
    # other) at 12 layers since the training run (s) joined the script, 8
    # since phase 4e did
    "b_int8w_int8kv_monolithic_T8": (
        dict(weight_int8=True, kv_dtype="int8", **SHORT),
        dict(block_size=8, kv_bucket_chunk=64, max_new_cap=72), 12, 32,
        ("flash_decode", "gemv_int8")),
    "c_bf16_T1": ({}, dict(block_size=1, max_new_cap=72), 2, 16,
                  ("flash_decode", "fused_ffn")),
    "d_bf16_drain_T1": ({}, dict(mode="drain", max_new_cap=72), 12, 32,
                        ("flash_decode", "fused_ffn")),
    # cut to 8 of 24 layers (SHORTER), as are (f) and (h) (SHORT): the
    # other configurations' runs below take their time
    "e_int8kv_split4_chunked_T8": (
        dict(kv_dtype="int8", **SHORTER),
        dict(block_size=8, kv_bucket_chunk=64, prefill_chunk=32,
             max_new_cap=72, a_shards=4), 12, 64,
        ("flash_decode", "flash_decode_partial", "fused_ffn")),
    # run (a)'s plan over a tiered cache: the boundary moves from 64 to 128
    # during decode (prompt 128, 64 new tokens); 12 layers since the
    # training run (s) joined the script (its host syncs are the plan's,
    # equal to (a)'s at any depth)
    "g_tiered_int4_chunked_T8": (
        dict(kv_cold_dtype="int4", **G_TIERS, **SHORTER),
        dict(block_size=8, kv_bucket_chunk=64, prefill_chunk=32,
             max_new_cap=72), 12, 64, ("flash_decode", "fused_ffn")),
    # runs (a) and (b) through the WA backend: QKV/FFN on the current
    # stream, the KV side on a stream of its own; (k) is (b) at depth 1 (it
    # changes only the admission program), (j) pipelines two micro-batches
    # across the streams and is served twice
    "i_wa_bf16_chunked_T8": (
        {}, dict(block_size=8, kv_bucket_chunk=64, prefill_chunk=32,
                 max_new_cap=72, backend="wa"), 12, 64,
        ("flash_decode", "fused_ffn")),
    "k_wa_int8w_int8kv_monolithic_T8": (
        dict(weight_int8=True, kv_dtype="int8", **SHORT),
        dict(block_size=8, kv_bucket_chunk=64, max_new_cap=72,
             backend="wa"), 12, 32, ("flash_decode", "gemv_int8")),
    "j_wa_int8w_int8kv_overlap2_T8": (
        dict(weight_int8=True, kv_dtype="int8", **SHORT),
        dict(block_size=8, kv_bucket_chunk=64, max_new_cap=72,
             backend="wa", overlap=2), 12, 32,
        ("flash_decode", "gemv_int8")),
}
# the other families and configurations at full width, after the qwen2
# runs: (l) qwen3-moe (64/4 heads: K1 in two launches of 8 heads, 128
# experts x 1536, top-8) with depth cut to 4 of 94 layers, ~22 GB of bf16
# weights, on (a)'s plan; (m) phi3.5-moe with depth cut to 4 of 32 layers
# (8 until the training mesh phase 4c joined), int8 weights (K4 on
# attention; the experts stay bf16) and int8 KV, monolithic, through WA at
# overlap 2 on (j)'s plan, served twice; (n) the paper's Llama-2-7B
# deployment (int8 weights and KV) at 8 of its 32 layers (16 since the
# training run (s) joined the script, 8 since phase 4c did), on (b)'s
# plan. MoE layers have no dense FFN: no K3.
FAMILY_RUNS = {
    # name: (arch, config overrides, engine kwargs, n_requests, max_new,
    #        kernels, the run whose plan and host syncs it repeats)
    "l_qwen3moe_4L_chunked_T8": (
        "qwen3-moe-235b-a22b", dict(n_layers=4),
        RUNS["a_bf16_chunked_T8"][1], 12, 64, ("flash_decode",),
        "a_bf16_chunked_T8"),
    "m_phi35moe_4L_int8_wa_overlap2_T8": (
        "phi3.5-moe-42b-a6.6b",
        dict(n_layers=4, weight_int8=True, kv_dtype="int8"),
        RUNS["j_wa_int8w_int8kv_overlap2_T8"][1], 12, 32,
        ("flash_decode", "gemv_int8"), "j_wa_int8w_int8kv_overlap2_T8"),
    "n_llama2_7b_int8_monolithic_T8": (
        "llama2-7b", dict(n_layers=8),
        RUNS["b_int8w_int8kv_monolithic_T8"][1], 12, 32,
        ("flash_decode", "gemv_int8"), "b_int8w_int8kv_monolithic_T8"),
}
TRACED = ("a_bf16_chunked_T8", "b_int8w_int8kv_monolithic_T8",
          "e_int8kv_split4_chunked_T8", "g_tiered_int4_chunked_T8",
          "i_wa_bf16_chunked_T8", "j_wa_int8w_int8kv_overlap2_T8",
          "l_qwen3moe_4L_chunked_T8", "n_llama2_7b_int8_monolithic_T8")
# each WA run: the colocated run whose plan, engine and host syncs it
# repeats, and the earlier runs its streams are compared with, each with
# whether they must be equal (only where the same programs run the same
# kernels at the same rows)
WA_TWINS = {
    "i_wa_bf16_chunked_T8": ("a_bf16_chunked_T8",
                             {"a_bf16_chunked_T8": True}),
    "k_wa_int8w_int8kv_monolithic_T8": (
        "b_int8w_int8kv_monolithic_T8",
        {"b_int8w_int8kv_monolithic_T8": False}),
    "j_wa_int8w_int8kv_overlap2_T8": (
        "b_int8w_int8kv_monolithic_T8",
        {"b_int8w_int8kv_monolithic_T8": False,
         "k_wa_int8w_int8kv_monolithic_T8": False}),
    "m_phi35moe_4L_int8_wa_overlap2_T8": (
        "j_wa_int8w_int8kv_overlap2_T8", {}),
}


def count_syncs(fn) -> int:
    """Synchronising CUDA calls made while ``fn()`` runs, as PyTorch's sync
    debug mode reports them: one warning each, logged with the line that
    made it. Any other warning is logged and not counted (the mode's
    notice, once a process, that it is a prototype is one)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = 0
    for w in caught:
        sync = "called a synchronizing CUDA operation" in str(w.message)
        n += sync
        log(f"      {'sync' if sync else 'not counted'}: {w.filename}:"
            f"{w.lineno}: {str(w.message).splitlines()[0][:120]}")
    return n


def decode_block_fn(api, params, T=8, kv_shards=1, B=8, impl=None):
    """One steady decode block: T micro-steps, B live rows at position 160
    of a fresh 200-position cache, KV bucket 192, through ``impl`` (a
    ``decode_block``; the model's by default)."""
    dev = api.device
    impl = impl or api.decode_block

    def block():
        caches = api.init_caches(B, 200)
        return impl(
            params, caches, torch.zeros(B, dtype=torch.int32, device=dev),
            torch.full((B,), 160, dtype=torch.int32, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev),
            torch.full((B,), T, dtype=torch.int32, device=dev),
            torch.full((B,), -1, dtype=torch.int32, device=dev),
            block_size=T, kv_bucket=192, kv_shards=kv_shards)
    return block


WALLS = (
    # label: (config overrides, shards)
    ("bfloat16 KV, 1 shard", {}, 1),
    ("bfloat16 KV, 4 shards", {}, 4),
    ("int8 KV, 1 shard", dict(kv_dtype="int8"), 1),
    ("int8 KV, 4 shards", dict(kv_dtype="int8"), 4),
    ("tiered int4 cold (hot 64, block 16), 1 shard",
     dict(kv_cold_dtype="int4", **G_TIERS), 1),
    ("tiered int8 cold (hot 32, block 16), 4 shards",
     dict(H_TIERS), 4),
)


def block_walls():
    """Wall time (host clock to a synchronise, median of 5) of one decode
    block at full qwen2-0.5b width, 8 layers (SHORT), for bf16 and int8 KV
    x 1 and 4 shards and the tiered caches of runs (g) and (h), in one
    process: what split-KV, int8 KV and the tiers add to a block."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    out = {}
    for label, over, n in WALLS:
        api = build_model(get_config("qwen2-0.5b").replace(**over,
                                                           **SHORT))
        params = api.init(0)
        block = decode_block_fn(api, params, kv_shards=n)
        block()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            block()
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
        out[label] = float(np.median(walls))
        del api, params
        torch.cuda.empty_cache()
    log("  one decode block (T=8, 8 rows at 160, bucket 192), untraced "
        "wall, median of 5: " + ", ".join(f"{k} {v:.2f} ms"
                                         for k, v in out.items()))
    return out


def drain_groups(reqs):
    """Admission groups of a drain run (admit step -> rids), checked: each
    group is admitted only after every request of the one before it has
    emitted its last token (prefill gives the first token, decode steps
    admit+0 .. admit+max_new-2 the rest)."""
    groups = {}
    for r in reqs:
        groups.setdefault(r.admit_step, []).append(r)
    order = sorted(groups)
    for a, b in zip(order, order[1:]):
        last = max(a + r.max_new_tokens - 2 for r in groups[a])
        require(b > last, f"drain admitted requests at step {b} while the "
                f"batch admitted at {a} decoded until step {last}")
    return {s: [r.rid for r in groups[s]] for s in order}


def union_spans(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def intersect_spans(x, y) -> float:
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0.0, hi - lo)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_overlap(prof):
    """Per-stream busy time (us, the union of its kernels' spans) and the
    time during which the two busiest streams both run a kernel, from the
    profiler's trace of kernel spans."""
    path = os.path.join(HERE, "build", "wa_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.unlink(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            stream = e.get("args", {}).get("stream", e.get("tid"))
            spans.setdefault(stream, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    unions = {k: union_spans(v) for k, v in spans.items()}
    busy = {k: sum(b - a for a, b in u) for k, u in unions.items()}
    top = sorted(busy, key=lambda k: -busy[k])[:2]
    both = intersect_spans(*(unions[k] for k in top)) if len(top) == 2 \
        else 0.0
    return busy, both


def trace_decode_block(api, params, kw, impl=None, efficiency=None):
    """Profile one steady decode block (T=8, 8 live rows at position 160,
    bucket 192): device busy time from the profiler's per-kernel sums
    against the block's wall time; prints the idle share, the kernels per
    token step and the ops that take most device time. With the WA
    backend's block (``impl``), also each stream's busy time and the time
    both streams run a kernel (the measured overlap) beside the schedule's
    ``overlap_efficiency``. Returns the synchronising calls one untraced
    block makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    T = kw["block_size"]
    shards = kw.get("a_shards", 1)
    block = decode_block_fn(api, params, T, shards, impl=impl)
    block()
    torch.cuda.synchronize()
    syncs = count_syncs(block)
    torch.cuda.synchronize()
    log(f"    synchronising calls inside one decode block: {syncs}")
    t0 = time.monotonic()
    block()
    torch.cuda.synchronize()
    wall_plain = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        block()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    # device rows only: op rows repeat their kernels' time as "self" time
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    if busy_us <= 0:
        log("    trace: profiler reported no device time (idle share not "
            "measured)")
        return syncs
    n_kern = sum(e.count for e in kern)
    log(f"    trace of one decode block (T={T}, 8 rows at 160, bucket 192"
        f"{', %d shards' % shards if shards > 1 else ''}): "
        f"wall {wall * 1e3:.2f} ms traced / {wall_plain * 1e3:.2f} ms "
        f"untraced, device busy {busy_us / 1e3:.2f} ms in "
        f"{n_kern} kernels ({n_kern / T:.1f} per token step), idle share "
        f"{1 - busy_us / 1e3 / (wall_plain * 1e3):.3f} of the untraced "
        f"wall")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"      {e.key[:64]:64s} {e.self_device_time_total / 1e3:8.3f} "
            f"ms, {e.count} launches")
    port = {}
    for e in kern:
        for tag in ("flash_decode", "gate_up_kernel", "down_kernel",
                    "gemv_int8"):
            if tag in e.key:
                us, n = port.get(tag, (0.0, 0))
                port[tag] = (us + e.self_device_time_total, n + e.count)
    log("      port kernels: " + ", ".join(
        f"{k} {us / 1e3:.3f} ms in {n} launches"
        for k, (us, n) in port.items()))
    if impl is not None:
        busy, both = stream_overlap(prof)
        log("      streams: " + ", ".join(
            f"stream {k} busy {us / 1e3:.3f} ms" for k, us in busy.items())
            + f"; both streams running a kernel {both / 1e3:.3f} ms "
            f"({both / max(1.0, min(busy.values(), default=1.0)):.3f} of "
            f"the less busy stream); schedule overlap_efficiency "
            f"{efficiency:.3f}")
    return syncs


# run (h): monolithic tiered admission (the full-width ``serve_admit`` chunk)
# with split-KV decode over 4 shards and the swap pair, served twice: with no
# budget, then under a KV byte budget of five slots priced at cursor 160 by
# the arbiter's own byte model. With arrivals every 4 steps and 4 blocks a
# request, a budget check sees at most six live slots (5.64 such prices at
# its peak, in the plan's CPU rehearsal), so six prices would never bind
# and five bind at three boundaries
H_ENGINE = dict(block_size=8, kv_bucket_chunk=64, max_new_cap=72,
                a_shards=4, preemptible=True)


def run_budget(totals, runs, card):
    """Run (h) at full qwen2-0.5b width (8 layers, seeded random bf16
    weights, int8 cold tier, hot 32 / blocks of 16), 8 slots, 12 requests x 32
    tokens. Both runs must complete every request with the same tokens;
    the budgeted one must preempt and restore; ``serve_admit`` (no
    ``serve_prefill1``), ``serve_swap_out`` and ``serve_swap_in`` are
    registered once each; K1 in partial mode and K3 launch in both."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serving import KVArbiter, ServingEngine
    cfg = get_config("qwen2-0.5b").replace(**H_TIERS, **SHORT)
    api = build_model(cfg)
    params = api.init(0)
    arb = KVArbiter(api.init_caches(8, 200, device="meta"))
    arb.observe(0, 160)
    price = arb.slot_occupancy(0)["kv_bytes"]
    budget = 5 * price
    log(f"  run (h): the arbiter prices a slot at cursor 160 at {price} B "
        f"(hot {arb.hot_bytes_per_token} B, cold "
        f"{arb.cold_bytes_per_token} B a token); budget {budget} B")
    streams = {}
    for tag, b in (("h_tiered_int8_mono_split4", 0),
                   ("h_tiered_int8_mono_split4_budget", budget)):
        reqs = make_requests(cfg, 12, 128, 32, seed=0, arrival_every=4)
        eng = ServingEngine(api, 8, 128, kv_budget_bytes=b, **H_ENGINE)
        torch.cuda.synchronize()
        reset_launch_counts()
        stats = eng.run(params, reqs)
        torch.cuda.synchronize()
        counts = launch_counts()
        runs[tag] = counts
        for k, n in counts.items():
            totals[k] += n
        rt = stats["runtime"]
        keys = ("completed", "preemptions", "restores", "host_syncs",
                "swap_time_ms", "tpot_mean_ms", "tpot_p99_ms")
        log(f"  run {tag}: launches {counts} [{card}]")
        log("    stats: " + json.dumps({k: stats[k] for k in keys}))
        log("    tiered: " + json.dumps(stats["tiered"]))
        log("    programs: " + ", ".join(
            f"{k}={v['calls']}" for k, v in rt.items() if v["calls"]))
        require(stats["completed"] == 12, f"{tag}: not all completed")
        for r in reqs:
            require(len(r.generated) == 32 and all(
                0 <= t < cfg.vocab_size for t in r.generated),
                f"{tag}: request {r.rid} stream malformed")
        for k in ("flash_decode_partial", "fused_ffn"):
            require(counts[k] > 0, f"{tag}: kernel {k} never launched")
        require("serve_prefill1" not in rt
                and all(rt[p]["compiles"] == 1 for p in
                        ("serve_admit", "serve_swap_out", "serve_swap_in")),
                f"{tag}: serve_admit and the swap pair are not registered "
                "once each")
        require(stats["tiered"]["demotions"] > 0,
                f"{tag}: the cold boundary never moved")
        streams[tag] = ({r.rid: r.generated for r in reqs}, stats)
    (free, _), (held, st) = streams.values()
    require(held == free, "run (h): the budgeted run's tokens differ from "
            "the unbudgeted run's")
    require(st["preemptions"] >= 1 and st["restores"] >= 1,
            "run (h): the budget never preempted and restored")
    require(st["runtime"]["serve_swap_in"]["calls"] >= 1,
            "run (h): serve_swap_in never ran")
    del params, api
    torch.cuda.empty_cache()


# run (f): the failure model at full width, 8 layers. The plan and its
# faults come from FaultPlan.generate(F_SEED); injected stalls and TTFT
# deadlines are cleared (they depend on wall time, which the card's runs
# do not share), and one scripted priority-3 arrival (F_SCRIPTED: prompt,
# tokens, arrival step) lands while every slot is busy, so the run
# preempts and restores. With no stop ids and no clock in any decision,
# the schedule is the same on every run.
F_SEED = 4
F_SCRIPTED = (24, 16, 8)
F_ENGINE = dict(block_size=8, kv_bucket_chunk=64, prefill_chunk=32,
                max_new_cap=72, preemptible=True, max_queue=6,
                max_retries=2, strict_invariants=True)


def run_failure(totals, runs, card):
    """Run (f): ``run_chaos`` (a clean run, then the chaos run with the
    plan's injector) through the colocated engine at full qwen2-0.5b width
    (8 layers, seeded random bf16 weights, int8 KV), 4 slots. Requires no
    invariant violation, completed streams equal to the clean run's, at
    least one injected failure, preemption and restore, K1 and K3 launched
    in both runs, and the swap pair registered once each."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.registry import build_model
    from repro_torch.runtime import faults
    from repro_torch.runtime.serving import Request, ServingEngine
    cfg = get_config("qwen2-0.5b").replace(kv_dtype="int8", **SHORT)
    api = build_model(cfg)
    params = api.init(0)
    plan = dataclasses.replace(faults.FaultPlan.generate(F_SEED,
                                                         n_requests=10),
                               slow_s=0.0, deadline_frac=0.0)
    reqs = plan.requests(cfg.vocab_size, prompt_lo=16, prompt_hi=128)
    plen, new, arrival = F_SCRIPTED
    reqs.append(Request(rid=len(reqs), prompt=np.random.default_rng(
        F_SEED).integers(0, cfg.vocab_size, plen, dtype=np.int32),
        max_new_tokens=new, arrival_step=arrival, priority=3))
    eng = ServingEngine(api, 4, 128, **F_ENGINE)
    per_run, swap_ms = [], {"out": [], "in": []}
    inner_run = eng.run

    def counted_run(p, rs, **kw):
        torch.cuda.synchronize()
        reset_launch_counts()
        stats = inner_run(p, rs, **kw)
        torch.cuda.synchronize()
        per_run.append((stats, launch_counts()))
        return stats

    def timed(fn, key):
        def wrapper(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            swap_ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    eng.run = counted_run
    eng._preempt_slot = timed(eng._preempt_slot, "out")
    eng._restore = timed(eng._restore, "in")
    rep = faults.run_chaos(eng, params, plan, reqs)
    (clean, clean_n), (chaos, chaos_n) = per_run
    for name, counts in (("f_chaos_clean", clean_n), ("f_chaos", chaos_n)):
        runs[name] = counts
        for k, n in counts.items():
            totals[k] += n
    log(f"  run f_failure_model (seed {F_SEED}, {len(reqs)} requests, 4 "
        f"slots, int8 KV): report {json.dumps(rep)}")
    keys = ("completed", "preemptions", "restores", "retries",
            "watchdog_timeouts", "quarantined_slots", "rejections",
            "deadline_misses", "host_syncs", "tpot_mean_ms",
            "swap_time_ms")
    for tag, st, n in (("clean", clean, clean_n), ("chaos", chaos, chaos_n)):
        log(f"    {tag} run: " + json.dumps({k: st[k] for k in keys})
            + f", launches {n} [{card}]")
    mean = {k: float(np.mean(v)) if v else float("nan")
            for k, v in swap_ms.items()}
    log(f"    host time a swap-out (export + copy to the host) "
        f"{mean['out']:.3f} ms over {len(swap_ms['out'])}, a swap-in "
        f"(copy back + masked write) {mean['in']:.3f} ms over "
        f"{len(swap_ms['in'])} [{card}]")
    log(f"    decode TPOT mean: clean {clean['tpot_mean_ms']:.3f} ms, chaos "
        f"{chaos['tpot_mean_ms']:.3f} ms [{card}]")
    require(rep["violations"] == [], f"run (f) invariant violations: "
            f"{rep['violations']}")
    require(clean["completed"] == len(reqs), "run (f): clean run incomplete")
    require(rep["completed"] + rep["rejections"] + rep["deadline_misses"]
            == len(reqs), "run (f): a request was not terminally accounted")
    require(rep["injected"]["injected_failures"] >= 1,
            "run (f): no dispatch failure was injected")
    require(chaos["preemptions"] >= 1 and chaos["restores"] >= 1,
            "run (f): no preemption and restore")
    for tag, n in (("clean", clean_n), ("chaos", chaos_n)):
        for k in ("flash_decode", "fused_ffn"):
            require(n[k] > 0, f"run (f) {tag}: kernel {k} never launched")
    rt = chaos["runtime"]
    require(all(rt[p]["compiles"] == 1 and rt[p]["calls"] >= 1
                for p in ("serve_swap_out", "serve_swap_in")),
            "run (f): the swap pair is not registered once and called")
    del params, eng, api
    torch.cuda.empty_cache()
    return {"swap_out_ms": mean["out"], "swap_in_ms": mean["in"],
            "tpot_mean_ms": chaos["tpot_mean_ms"]}


def phase_engine(totals, runs):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serving import ServingEngine
    per_step, syncs, host_syncs, streams = {}, {}, {}, {}
    plans = [(name, "qwen2-0.5b", *spec, None)
             for name, spec in RUNS.items()]
    plans += [(name, *spec) for name, spec in FAMILY_RUNS.items()]
    for name, arch, over, kw, n_req, max_new, needed, twin in plans:
        t_run = time.monotonic()
        cfg = get_config(arch).replace(**over)
        api = build_model(cfg)
        t0 = time.monotonic()
        params = api.init(0)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        reqs = make_requests(cfg, n_req, 128, max_new, seed=0,
                             arrival_every=4)
        eng = ServingEngine(api, 8, 128, **kw)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.monotonic()
        stats = eng.run(params, reqs)
        torch.cuda.synchronize()
        serve_s = time.monotonic() - t0
        counts = launch_counts()
        runs[name] = counts
        for k, n in counts.items():
            totals[k] += n
        per_req = stats.pop("per_request")
        runtime = stats.pop("runtime")
        log(f"  run {name}: init {init_s:.1f}s, serve {serve_s:.1f}s, "
            f"launches {counts}")
        log(f"    stats: {json.dumps(stats)}")
        log(f"    programs: " + ", ".join(
            f"{k}={v['calls']}" for k, v in runtime.items() if v["calls"]))
        log(f"    decode TPOT mean {stats['tpot_mean_ms']:.3f} ms, p50 "
            f"{stats['tpot_p50_ms']:.3f} ms, p99 {stats['tpot_p99_ms']:.3f} "
            f"ms; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        require(stats["completed"] == n_req, f"{name}: not all completed")
        for r in reqs:
            require(len(r.generated) == max_new and all(
                0 <= t < cfg.vocab_size for t in r.generated),
                f"{name}: request {r.rid} stream malformed")
        require(len(per_req) == n_req, f"{name}: per-request stats missing")
        for k in needed:
            require(counts[k] > 0, f"{name}: kernel {k} never launched")
        if twin is not None:
            # another configuration: exactly its path's kernels launch
            require(all(n == 0 for k, n in counts.items()
                        if k not in needed), f"{name}: a kernel off its "
                    f"path launched: {counts}")
            log(f"    {arch} x {cfg.n_layers} layers: host syncs "
                f"{stats['host_syncs']} ({twin}: {host_syncs[twin]})")
            require(stats["host_syncs"] == host_syncs[twin],
                    f"{name}: another number of host syncs than {twin}")
        if "tiered" in stats:
            require(stats["tiered"]["demotions"] > 0,
                    f"{name}: the cold boundary never moved")
        host_syncs[name] = stats["host_syncs"]
        streams[name] = {r.rid: list(r.generated) for r in reqs}
        if kw.get("mode") == "drain":
            log(f"    drain admission groups (step: rids): "
                f"{drain_groups(reqs)}")
        wa = eng._ex.wa if kw.get("backend") == "wa" else None
        if wa is not None:
            log(f"    wa: {json.dumps(stats['wa'])}")
            twin, compared = WA_TWINS[name]
            for other, must in compared.items():
                same = sum(streams[name][r] == streams[other][r]
                           for r in streams[name])
                first = sorted(next((i for i, (x, y) in enumerate(zip(
                    streams[name][r], streams[other][r])) if x != y),
                    max_new) for r in streams[name])
                log(f"    streams equal to run {other}'s: {same}/{n_req} "
                    f"(first differing token of each request: {first})")
                if must:
                    require(same == n_req, f"{name}: tokens differ from "
                            f"{other}'s (depth 1 runs the same kernels in "
                            "the same order)")
            log(f"    host syncs {host_syncs[name]} ({twin}: "
                f"{host_syncs[twin]})")
            require(host_syncs[name] == host_syncs[twin],
                    f"{name}: another number of host syncs than {twin}")
            if kw.get("overlap", 1) > 1:
                # served again on the same engine: the race check at depth
                # 2 (fresh caches, the same plan, the same tokens)
                again = make_requests(cfg, n_req, 128, max_new, seed=0,
                                      arrival_every=4)
                reset_launch_counts()
                stats2 = eng.run(params, again)
                torch.cuda.synchronize()
                counts2 = launch_counts()
                runs[name + "_again"] = counts2
                for k, n in counts2.items():
                    totals[k] += n
                log(f"    served again: completed {stats2['completed']}, "
                    f"launches {counts2}, TPOT mean "
                    f"{stats2['tpot_mean_ms']:.3f} ms")
                require(stats2["completed"] == n_req
                        and {r.rid: r.generated for r in again}
                        == streams[name], f"{name}: the second serve's "
                        "tokens differ from the first's")
        if name in TRACED:
            syncs[name] = trace_decode_block(
                api, params, kw, impl=None if wa is None else
                wa.decode_block, efficiency=None if wa is None else
                stats["wa"]["overlap_efficiency"])
            # launches of one decode step (T = 1)
            caches = api.init_caches(8, 200)
            z = torch.zeros(8, dtype=torch.int32, device=api.device)
            on = torch.ones(8, dtype=torch.bool, device=api.device)
            reset_launch_counts()
            if wa is None:
                api.decode_slotted(params, caches, z, z + 100, on,
                                   kv_bucket=128,
                                   kv_shards=kw.get("a_shards", 1))
            else:
                wa.decode_step_slotted(params, caches, z, z + 100, on,
                                       kv_bucket=128)
            torch.cuda.synchronize()
            per_step[name] = {k: n for k, n in launch_counts().items() if n}
        del params, eng, api
        torch.cuda.empty_cache()
        log(f"    run {name} took {time.monotonic() - t_run:.1f}s (serve, "
            f"checks, trace)")
    a, e, g = ("a_bf16_chunked_T8", "e_int8kv_split4_chunked_T8",
               "g_tiered_int4_chunked_T8")
    log(f"  host syncs: (a) {host_syncs[a]}, (e) {host_syncs[e]}, (g) "
        f"{host_syncs[g]}; synchronising calls in one traced decode block: "
        f"{syncs}")
    require(host_syncs[e] == host_syncs[a],
            "split-KV run (e) made another number of host syncs than (a)")
    require(host_syncs[g] == host_syncs[a],
            "tiered run (g) made another number of host syncs than (a)")
    require(all(n == 0 for n in syncs.values()),
            "a traced decode block synchronises with the host")
    card = nvidia_smi()
    for fn in (lambda: run_budget(totals, runs, card),
               lambda: run_failure(totals, runs, card), block_walls,
               lambda: wa_block_walls(card)):
        t_run = time.monotonic()
        fn()
        log(f"    took {time.monotonic() - t_run:.1f}s")
    return per_step, host_syncs


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------

def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def time_ms(fn, variants, iters) -> float:
    """Mean DEVICE time of ``fn(*args, **kw)`` over ``iters`` launches that
    rotate through ``variants`` (input copies whose total exceeds the L2,
    so every launch reads cold inputs as a layer-by-layer caller does).

    The host enqueues a launch more slowly than a small kernel runs, so the
    stream is first held by a spin kernel (``torch.cuda._sleep``) long
    enough for every launch to be queued behind it; the events then bracket
    back-to-back device work. A window whose start event had already
    completed when the host finished queueing (the CUDA launch queue
    filled, or the spin was short) is retried with fewer launches and a
    longer spin."""
    for args, kw in variants[:2]:
        fn(*args, **kw)
    torch.cuda.synchronize()
    for _ in range(8):
        t0 = time.perf_counter()
        for i in range(iters):
            args, kw = variants[i % len(variants)]
            fn(*args, **kw)
        spin = 2.0 * (time.perf_counter() - t0) + 2e-3
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin * 2.0e9))        # cycles at <= 2 GHz
        start.record()
        for i in range(iters):
            args, kw = variants[i % len(variants)]
            fn(*args, **kw)
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        iters = max(4, iters // 2)
    raise AssertionError(f"could not queue {fn} ahead of the device")


def host_ms(fn, variants, iters=50) -> float:
    """Host time to enqueue one call of ``fn`` (the wrapper's Python, its
    checks and its launches), mean over ``iters`` calls queued without a
    synchronise: what a call adds to the host-bound decode loop."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        args, kw = variants[i % len(variants)]
        fn(*args, **kw)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def variants_of(make, per_call_bytes):
    n = max(2, min(64, math.ceil(2 * L2_BYTES / max(per_call_bytes, 1))))
    return [make(i) for i in range(n)]


def tiered_inputs(dev, cold, seed=0, B=8, Hq=14, n_kv=2, hd=64, S=200,
                  bucket=192):
    """One tiered layer as run (g) holds it at cursor 160: the cold tier of
    S positions (int8 or packed int4 with scales), the bf16 ring of 80, a
    bf16 query, counts 161, the (B, bucket) mask and kv_limit 161."""
    from repro_torch.kv.cache import batch_valid_mask, quantize_cold
    g = torch.Generator(device=dev).manual_seed(seed)
    kq, ks = quantize_cold(torch.randn(B, n_kv, S, hd, device=dev,
                                       generator=g), cold)
    vq, vs = quantize_cold(torch.randn(B, n_kv, S, hd, device=dev,
                                       generator=g), cold)
    H = G_TIERS["hot_window"] + G_TIERS["kv_cold_block"]
    hk, hv = (torch.randn(B, n_kv, H, hd, device=dev, generator=g)
              .to(torch.bfloat16) for _ in range(2))
    q = torch.randn(B, Hq, hd, device=dev, generator=g).to(torch.bfloat16)
    pos = torch.full((B,), 160, dtype=torch.int32, device=dev)
    return (q, kq, vq, ks, vs, hk, hv, pos + 1, batch_valid_mask(bucket, pos),
            (pos.max() + 1).to(torch.int32), cold)


def tiered_bytes(args) -> int:
    """Bytes the tiered attention of one layer must move: for each row, the
    cold K/V below its boundary with their scales and the ring slots of
    [boundary, counts); then q, counts, the mask, kv_limit and the bf16
    output. Cold positions at or past the boundary and ring slots past
    counts are never needed."""
    from repro_torch.kv.cache import cold_boundary
    q, k, v, ks, vs, hk, hv, counts, mask, lim = args[:10]
    edge = cold_boundary(counts, G_TIERS["hot_window"],
                         G_TIERS["kv_cold_block"])
    n_cold, n_hot = int(edge.sum()), int((counts - edge).sum())
    cold_row = sum(t.shape[-1] * t.element_size() for t in (k, v, ks, vs))
    hot_row = sum(t.shape[-1] * t.element_size() for t in (hk, hv))
    return (k.shape[1] * (n_cold * cold_row + n_hot * hot_row)
            + nbytes(q, counts, mask, lim) + q.numel() * 2)


def resolve_tiered(k, v, ks, vs, hk, hv, counts, cold, bucket=192):
    """The bf16 image ``layer_read_tiered`` resolves for run (g)'s tiers."""
    from repro_torch.kv.cache import layer_read_tiered
    return layer_read_tiered(k, v, ks, vs, hk, hv, counts, bucket,
                             G_TIERS["hot_window"], G_TIERS["kv_cold_block"],
                             cold, dtype=torch.bfloat16)


def tiered_attention(q, k, v, ks, vs, hk, hv, counts, mask, lim, cold,
                     k1=None):
    """One layer's tiered decode attention as ``block_decode_slotted`` runs
    it: the resolve, then K1 (or ``k1``) in float mode over the image."""
    from repro_torch.kernels.flash_decode.ops import flash_decode
    kc, vc = resolve_tiered(k, v, ks, vs, hk, hv, counts, cold)
    return (k1 or flash_decode)(q, kc, vc, mask, kv_limit=lim)


def tiered_append_inputs(args):
    """``layer_append_tiered`` operands for a ``tiered_inputs`` layer: new
    bf16 K/V for 8 rows at cursor 160, every row active."""
    q, k, v, ks, vs, hk, hv, counts = args[:8]
    g = torch.Generator(device=q.device).manual_seed(1)
    kn, vn = (torch.randn(hk.shape[0], hk.shape[1], hk.shape[3],
                          device=q.device, generator=g).to(torch.bfloat16)
              for _ in range(2))
    return (k, v, ks, vs, hk, hv, kn, vn, counts - 1,
            torch.ones_like(counts, dtype=torch.bool))


def tiered_append(*a, cold_dtype):
    from repro_torch.kv.cache import layer_append_tiered
    return layer_append_tiered(*a[:9], cold_dtype, a[9])


def count_kernels(fn, variant) -> int:
    """Device kernels one call of ``fn`` launches, from torch.profiler
    (0 when the profiler sees no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args, kw = variant
    fn(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args, **kw)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def phase_timing(dev, launches, runs, per_step, errs):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                      flash_decode_partial)
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    from repro_torch.kernels.gemv.ops import gemv_int8_q
    from repro_torch.kernels.gemv.ref import gemv_int8_ref
    from repro_torch.models.attention import decode_attention_split
    rows = []

    def sdpa_args(var):
        """SDPA (GQA) inputs for K1 input variants: the query as one
        position, K/V dequantized to bf16, the mask broadcast over heads."""
        sd = []
        for (q_, k_, v_, m_, ks_, vs_, _), _ in var:
            kd = k_ if ks_ is None else (k_.float() * ks_).to(torch.bfloat16)
            vd = v_ if vs_ is None else (v_.float() * vs_).to(torch.bfloat16)
            sd.append(((q_[:, :, None], kd, vd),
                       dict(attn_mask=m_[:, None, None, :], enable_gqa=True)))
        return sd

    def bound(nb, ops, dtype):
        t_b = nb / HBM_BYTES_PER_S * 1e3
        t_o = ops / PEAK_OPS[dtype] * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    # K1 at the engine's largest bucket (200, no multiple of 16) and at a
    # long context (4096), every position live
    for S, kv in ((200, "bfloat16"), (200, "int8"), (4096, "bfloat16"),
                  (4096, "int8")):
        q, k, v, mask, ks, vs, lim = k1_inputs(dev, 8, S, ("bfloat16", kv))
        nb = nbytes(q, k, v, mask, ks, vs) + q.numel() * 4
        ops = 2 * 2 * q.shape[0] * q.shape[1] * S * q.shape[2]
        b_ms, b_by = bound(nb, ops, torch.bfloat16)
        var = variants_of(lambda i: (k1_inputs(dev, 8, S, ("bfloat16", kv),
                                               seed=i), {}), nb)
        ms = time_ms(flash_decode, var, 400)
        plain = time_ms(flash_decode_ref, var, 50)
        lib = {"sdpa(enable_gqa) on dequantized bf16 K/V":
               time_ms(F.scaled_dot_product_attention, sdpa_args(var), 400)}
        rows.append(("flash_decode", f"B=8 Hq=14 n_kv=2 hd=64 S={S} kv={kv}",
                     ms, plain, b_ms, b_by, lib, host_ms(flash_decode, var)))
        log(f"  K1 S={S} kv={kv}: {nb / 1e6:.3f} MB moved")
    # K1 in partial mode at one shard of the split path (bucket 192 over 4
    # shards: Sb = 48), every position live; no PyTorch call returns the
    # raw (o, m, l), so SDPA over the same shard (normalised) is the
    # yardstick
    for kv in ("bfloat16", "int8"):
        q, k, v, mask, ks, vs, lim = k1_inputs(dev, 8, 48, ("bfloat16", kv))
        B, Hq, hd = q.shape
        nb = nbytes(q, k, v, mask, ks, vs) + B * Hq * (hd + 2) * 4
        b_ms, b_by = bound(nb, 4 * B * Hq * 48 * hd, torch.bfloat16)
        var = variants_of(lambda i: (k1_inputs(dev, 8, 48, ("bfloat16", kv),
                                               seed=i), {}), nb)
        ms = time_ms(flash_decode_partial, var, 400)
        plain = time_ms(lambda *a: flash_decode_ref(*a, partial_stats=True),
                        var, 50)
        lib = {"sdpa(enable_gqa) on the same shard, normalised":
               time_ms(F.scaled_dot_product_attention, sdpa_args(var), 400)}
        rows.append(("flash_decode_partial", f"partial, one shard: B=8 "
                     f"Hq=14 n_kv=2 hd=64 Sb=48 kv={kv}", ms, plain, b_ms,
                     b_by, lib, host_ms(flash_decode_partial, var)))
    # the whole split attention of one layer at bucket 192 over 4 shards (4
    # partial K1 launches + the LSE combine + the cast), against K1 once
    # over the same bucket and SDPA over the whole bucket
    for kv in ("bfloat16", "int8"):
        (q, k, v, mask, ks, vs, lim), _ = split_inputs(dev, 192, 4, kv,
                                                       ragged=False)
        B, Hq, hd = q.shape
        nb = nbytes(q, k, v, mask, ks, vs) + B * Hq * hd * 2
        b_ms, b_by = bound(nb, 4 * B * Hq * 192 * hd, torch.bfloat16)

        def make(i):
            return split_inputs(dev, 192, 4, kv, ragged=False, seed=i)[0], {}
        var = variants_of(make, nb)
        ms = time_ms(decode_attention_split, var, 40)
        plain = time_ms(split_plain, var, 10)
        whole = [((a[0], a[1].flatten(2, 3), a[2].flatten(2, 3), a[3],
                   None if a[4] is None else a[4].flatten(2, 3),
                   None if a[5] is None else a[5].flatten(2, 3), a[6]), {})
                 for a, _ in var]
        lib = {"K1 once over the whole bucket": time_ms(flash_decode, whole,
                                                        400),
               "sdpa(enable_gqa) on dequantized bf16 K/V of the bucket":
               time_ms(F.scaled_dot_product_attention, sdpa_args(whole),
                       400)}
        rows.append(("flash_decode", f"split attention, 4 shards: B=8 Hq=14 "
                     f"n_kv=2 hd=64 bucket=192 kv={kv}", ms, plain, b_ms,
                     b_by, lib, host_ms(decode_attention_split, var)))
    # the tiered attention of one layer as run (g) decodes it: B=8 rows at
    # cursor 160 of a 200-position cache with run (g)'s ring of 80 (the
    # boundary at 96), bucket 192: the resolve (cold dequantize, ring tile
    # and select, plain PyTorch) plus K1 in float mode over the bf16 image.
    # Bound: what the function needs read once: the cold tier below the
    # boundary with its scales, the ring slots from the boundary to counts,
    # q, mask and output. Yardsticks: K1 once over a flat bf16 bucket of 192,
    # and SDPA over the resolved image
    for cold in ("int8", "int4"):
        var = variants_of(lambda i: (tiered_inputs(dev, cold, seed=i), {}),
                          tiered_bytes(tiered_inputs(dev, cold)))
        nb = tiered_bytes(var[0][0])
        q0, counts0 = var[0][0][0], var[0][0][7]
        b_ms, b_by = bound(nb, 4 * q0.shape[1] * q0.shape[2]
                           * int(counts0.sum()), torch.bfloat16)
        ms = time_ms(tiered_attention, var, 40)
        plain = time_ms(lambda *a: tiered_attention(*a, k1=flash_decode_ref),
                        var, 10)
        flat = variants_of(lambda i: (k1_inputs(dev, 8, 192, seed=i), {}),
                           nb)
        images = [((a[0][:, :, None], *resolve_tiered(*a[1:8], cold)),
                   dict(attn_mask=a[8][:, None, None, :], enable_gqa=True))
                  for a, _ in var]
        lib = {"K1 once over a flat bf16 bucket of 192":
               time_ms(flash_decode, flat, 400),
               "sdpa(enable_gqa) over the resolved bf16 image":
               time_ms(F.scaled_dot_product_attention, images, 400)}
        rows.append(("flash_decode", f"tiered attention of one layer "
                     f"(resolve + K1): B=8 Hq=14 n_kv=2 hd=64 bucket=192 "
                     f"cold={cold} ring=80", ms, plain, b_ms, b_by, lib,
                     host_ms(tiered_attention, var)))
        # the tiered append of one layer (both tiers, 8 rows): plain
        # PyTorch; device time, host time and the kernels it launches
        app = [(tiered_append_inputs(a), {"cold_dtype": cold})
               for a, _ in var]
        app_ms = time_ms(tiered_append, app, 40)
        app_host = host_ms(tiered_append, app)
        log(f"  tiered append of one layer, cold={cold} (8 rows, ring 80): "
            f"{app_ms * 1e3:.2f} us device, {app_host * 1e3:.2f} us host a "
            f"call, {count_kernels(tiered_append, app[0])} kernels a call")
    # K3 at decode (8 rows), chunk (32 rows), monolithic-prefill (128
    # rows) and drain batch-prefill (1,024 rows) widths
    for R in (8, 32, 128, 1024):
        (x, wg, wu, wd), kw = k3_inputs(dev, R)
        D, F_ = wg.shape
        nb = nbytes(x, wg, wu, wd) + R * D * 4
        ops = 2 * R * D * F_ * 3
        b_ms, b_by = bound(nb, ops, torch.bfloat16)
        var = variants_of(lambda i: k3_inputs(dev, R, seed=i), nb)
        ms = time_ms(fused_ffn, var, 200)
        plain = time_ms(fused_ffn_ref, var, 50)

        def lib_ffn(x, wg, wu, wd, act="silu"):
            return torch.matmul(F.silu(torch.matmul(x, wg))
                                * torch.matmul(x, wu), wd)
        lib = {"3x torch.matmul + silu (bf16)": time_ms(lib_ffn, var, 200)}
        rows.append(("fused_ffn", f"rows={R} D=896 F=4864 bf16", ms, plain,
                     b_ms, b_by, lib, host_ms(fused_ffn, var)))
    # K4 at decode (8) and prefill (128) rows for each projection shape
    for R in (8, 128):
        for K, N in ((896, 896), (896, 128), (896, 4864), (4864, 896)):
            (xq, xs, wq, ws), _ = k4_inputs(dev, R, K, N)
            nb = nbytes(xq, xs, wq, ws) + R * N * 4
            ops = 2 * R * K * N
            b_ms, b_by = bound(nb, ops, torch.int8)
            var = variants_of(lambda i: k4_inputs(dev, R, K, N, seed=i), nb)
            ms = time_ms(gemv_int8_q, var, 400)
            plain = time_ms(gemv_int8_ref, var, 50)
            # yardsticks: a bf16 matmul on the dequantized weights, and the
            # same integer product by torch._int_mm, which needs more than
            # 16 rows (padded to 32 at decode rows) and K, N multiples of 8
            dq = [((a[0].to(torch.bfloat16),
                    (a[2].float() * a[3]).to(torch.bfloat16)), {})
                  for a, _ in var]
            pad = max(R, 32)
            im = [((torch.cat([a[0], a[0].new_zeros(pad - R, K)]), a[2]), {})
                  for a, _ in var]
            lib = {"bf16 torch.matmul on dequantized weights":
                   time_ms(torch.matmul, dq, 400)}
            try:
                lib[f"torch._int_mm, rows padded to {pad}"] = \
                    time_ms(torch._int_mm, im, 400)
            except RuntimeError as e:        # a yardstick only: say why
                log(f"  torch._int_mm refused {K}x{N}: {e}")
                lib[f"torch._int_mm, rows padded to {pad}"] = None
            rows.append(("gemv_int8", f"rows={R} K={K} N={N}", ms, plain,
                         b_ms, b_by, lib, host_ms(gemv_int8_q, var)))
    # the other configurations' shapes: K1 at qwen3-moe's G=16 (two
    # launches of 8 heads over the same K/V), K4 at the paper's Llama
    # projections and K3 at Llama-2-7B's FFN, each at decode rows
    for S, kv in ((200, "bfloat16"), (200, "int8"), (4096, "bfloat16"),
                  (4096, "int8")):
        shape = dict(Hq=64, n_kv=4, hd=128)
        q, k, v, mask, ks, vs, lim = k1_inputs(dev, 8, S, ("bfloat16", kv),
                                               **shape)
        nb = nbytes(q, k, v, mask, ks, vs) + q.numel() * 4
        b_ms, b_by = bound(nb, 4 * q.shape[0] * q.shape[1] * S * 128,
                           torch.bfloat16)
        var = variants_of(lambda i: (k1_inputs(dev, 8, S, ("bfloat16", kv),
                                               seed=i, **shape), {}), nb)
        lib = {"sdpa(enable_gqa) on dequantized bf16 K/V":
               time_ms(F.scaled_dot_product_attention, sdpa_args(var), 400)}
        rows.append(("flash_decode", f"G=16 (2 launches of 8 heads): B=8 "
                     f"Hq=64 n_kv=4 hd=128 S={S} kv={kv}",
                     time_ms(flash_decode, var, 400),
                     time_ms(flash_decode_ref, var, 50), b_ms, b_by, lib,
                     host_ms(flash_decode, var)))
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096), (3072, 8192)):
        (xq, xs, wq, ws), _ = k4_inputs(dev, 8, K, N)
        nb = nbytes(xq, xs, wq, ws) + 8 * N * 4
        b_ms, b_by = bound(nb, 2 * 8 * K * N, torch.int8)
        var = variants_of(lambda i: k4_inputs(dev, 8, K, N, seed=i), nb)
        dq = [((a[0].to(torch.bfloat16),
                (a[2].float() * a[3]).to(torch.bfloat16)), {})
              for a, _ in var]
        im = [((torch.cat([a[0], a[0].new_zeros(24, K)]), a[2]), {})
              for a, _ in var]
        lib = {"bf16 torch.matmul on dequantized weights":
               time_ms(torch.matmul, dq, 400),
               "torch._int_mm, rows padded to 32": time_ms(torch._int_mm, im,
                                                           400)}
        rows.append(("gemv_int8", f"Llama: rows=8 K={K} N={N}",
                     time_ms(gemv_int8_q, var, 400),
                     time_ms(gemv_int8_ref, var, 50), b_ms, b_by, lib,
                     host_ms(gemv_int8_q, var)))
    for R in (8, 32, 128):
        (x, wg, wu, wd), kw = k3_inputs(dev, R, D=4096, F=11008)
        nb = nbytes(x, wg, wu, wd) + R * 4096 * 4
        b_ms, b_by = bound(nb, 2 * R * 4096 * 11008 * 3, torch.bfloat16)
        var = variants_of(lambda i: k3_inputs(dev, R, seed=i, D=4096,
                                              F=11008), nb)

        def lib_ffn(x, wg, wu, wd, act="silu"):
            return torch.matmul(F.silu(torch.matmul(x, wg))
                                * torch.matmul(x, wu), wd)
        lib = {"3x torch.matmul + silu (bf16)": time_ms(lib_ffn, var, 100)}
        rows.append(("fused_ffn", f"Llama-2-7B FFN: rows={R} D=4096 F=11008 "
                     f"bf16", time_ms(fused_ffn, var, 100),
                     time_ms(fused_ffn_ref, var, 20), b_ms, b_by, lib,
                     host_ms(fused_ffn, var)))
    rows += recurrent_timing_rows(dev, bound, sdpa_args)
    rows += vlm_encdec_timing_rows(dev, bound, sdpa_args)
    rows += train_timing_rows(dev, bound)
    rows += mesh_timing_rows(dev, bound, sdpa_args)
    rows += train_mesh_timing_rows(dev, bound)
    rows += pp_family_timing_rows(dev, bound, sdpa_args)
    rows += fam_train_timing_rows(dev, bound)
    rows += tier_mesh_timing_rows(dev, bound, sdpa_args)
    for name, shape, ms, plain, b_ms, b_by, lib, host in rows:
        libs = ", ".join(("not measured" if v is None else
                          f"{v * 1e3:.2f} us") + f" ({k})"
                         for k, v in lib.items())
        steps = ", ".join(f"{run[0]} {c.get(name, 0)}"
                          for run, c in per_step.items())
        log(f"  {name} [{shape}]: {ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} "
            f"us ({b_by}), plain {plain * 1e3:.2f} us, library {libs}; "
            f"host {host * 1e3:.2f} us a call; launches per decode step "
            f"{steps}")
    out = []
    for name in REPLACES:
        mine = [r for r in rows if r[0] == name]
        first = mine[0]
        src = {"flash_decode": "flash_decode/csrc/flash_decode.cu",
               "flash_decode_partial": "flash_decode/csrc/flash_decode.cu",
               "fused_ffn": "fused_ffn/csrc/fused_ffn.cu",
               "gemv_int8": "gemv/csrc/gemv_int8.cu"}[name]
        out.append({"name": name, "status": "ported", "route": "cuda",
                    "source": "src/repro_torch/kernels/" + src,
                    "replaces": REPLACES[name],
                    "launches": launches[name],
                    "launches_by_run": {run: c.get(name, 0) for run, c in
                                        runs.items()},
                    "max_abs_err": errs[name],
                    "ms": first[2], "plain_ms": first[3],
                    "bound_ms": first[4], "bound_by": first[5],
                    "library_ms": next(iter(first[6].values())),
                    "shapes": [{"shape": r[1], "ms": r[2], "plain_ms": r[3],
                                "bound_ms": r[4], "bound_by": r[5],
                                "library_ms": r[6], "host_ms": r[7]}
                               for r in mine]})
    return out


def phase_hops(card):
    """Host and device time of one W->A->W hop pair of the WA backend (an
    event recorded on W and waited on by A, the switch to the A stream and
    back, an event recorded on A and waited on by W, ``record_stream`` on
    q, k, v and o) against one colocated decode layer-step and the same
    layer-step through the W/A split, at full
    qwen2-0.5b width (bf16, 8 rows at 160, bucket 192). Device times by
    ``time_ms``; host times by ``host_ms``, the median of 5 rounds that
    alternate the two layer-steps (host clocks drift within a call)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.wa import WADisaggregated
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    cfg = get_config("qwen2-0.5b")
    api = build_model(cfg)
    dev = api.device
    wa = WADisaggregated(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def make(i):
        lp = T.make_block_params(gen, cfg)
        x = torch.randn(8, 1, cfg.d_model, device=dev,
                        generator=gen).to(torch.bfloat16)
        pos = torch.full((8,), 160, dtype=torch.int32, device=dev)
        return (lp, x, api.init_caches(8, 200).layer(0), pos,
                torch.ones(8, dtype=torch.bool, device=dev),
                (pos.max() + 1).to(torch.int32)), {}

    def colocated(lp, x, kv, pos, act, lim):
        return T.block_decode_slotted(lp, x, cfg, kv, pos, act,
                                      kv_bucket=192, kv_limit=lim)

    def split(lp, x, kv, pos, act, lim):
        q, k, v = T.pre_attention(lp, x, pos[:, None], cfg)
        o, ev = wa._a_op(0, wa._to_a(0, q, k, v), T.attend_decode_slotted,
                         q, k, v, kv, pos, act, cfg, 192, lim)
        wa._to_w(ev)
        return T.post_attention(lp, x, o, cfg)

    hd = cfg.head_dim
    layer_bytes = 2 * (cfg.d_model * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                       * hd + 3 * cfg.d_model * cfg.d_ff)
    var = variants_of(make, layer_bytes)
    q = torch.randn(8, 1, 14, 64, device=dev).to(torch.bfloat16)
    kk, vv = q[:, :, :2].clone(), q[:, :, :2].clone()
    w, a = torch.cuda.current_stream(dev), wa._a
    ev = torch.cuda.Event()

    def hop_pair(q, k, v, o):
        _, back = wa._a_op(0, wa._to_a(0, q, k, v), lambda: o)
        wa._to_w(back)

    hops = [((q, kk, vv, q[:, 0].clone()), {})]
    rows = {"W->A->W hop pair": (
        time_ms(hop_pair, hops, 400),
        float(np.median([host_ms(hop_pair, hops, 200) for _ in range(5)])))}
    layers = {"colocated layer-step": colocated,
              "WA layer-step (the same ops, one hop pair)": split}
    dev_ms = {k: time_ms(fn, var, 40) for k, fn in layers.items()}
    hosts = {k: [] for k in layers}
    for _ in range(5):
        for k, fn in layers.items():
            hosts[k].append(host_ms(fn, var))
    for k in layers:
        rows[k] = (dev_ms[k], float(np.median(hosts[k])))
    for label, (d, host) in rows.items():
        log(f"  {label}: device {d * 1e3:.2f} us, host {host * 1e3:.2f} us "
            f"a call [{card}]")
    # can W and A run at once at all? Two ~1 ms spin kernels, one per
    # stream between a fork and a join, against both on W (CUDA events)
    spins = {}
    for label, second in (("one on W, one on A", a), ("both on W", w)):
        times = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record(w)
            ev.record(w)
            a.wait_event(ev)
            torch.cuda._sleep(1_000_000)
            with torch.cuda.stream(second):
                torch.cuda._sleep(1_000_000)
            back = a.record_event()
            w.wait_event(back)
            end.record(w)
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        spins[label] = float(np.median(times))
    log("  two spin kernels of 1,000,000 cycles between a fork and a join, "
        "median of 5: " + ", ".join(f"{k} {v:.3f} ms"
                                    for k, v in spins.items())
        + f" [{card}]")
    rows["spins"] = spins
    del api, var
    torch.cuda.empty_cache()
    return rows


def phase_moe_timing(card):
    """Device time of one MoE layer's FFN half at decode (8 rows, bf16) for
    qwen3-moe (128 experts x 1536, top-8) and phi3.5-moe (16 x 6400, top-2)
    widths, split into its stages (``models/moe.py``): router + top-k +
    sort-based dispatch + the bucket copy; the experts'
    three batched products over all E x C slots; the gather-and-sum
    combine. Each stage reads its operands from device memory (the expert
    weights are far past the L2). Bound of the products: their weights
    read once over 3.35 TB/s."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    dev = torch.device("cuda")
    for arch in ("qwen3-moe-235b-a22b", "phi3.5-moe-42b-a6.6b"):
        cfg = get_config(arch)
        m = cfg.moe
        K, E, D = m.experts_per_token, m.num_experts, cfg.d_model
        gen = torch.Generator(device=dev).manual_seed(0)
        p = moe.make_moe_params(gen, cfg)
        x = torch.randn(8, 1, D, device=dev, generator=gen).to(torch.bfloat16)
        xf = x.reshape(8, D)
        C = moe.capacity(8, cfg)

        def route_dispatch():
            _, gv, gi = moe.route(p, xf, K)
            order, slot, keep = moe.dispatch(gi, E, C)
            return (moe.gather_tokens(xf, order, slot, K, E, C), order, slot,
                    keep, gv)

        disp, order, slot, keep, gv = route_dispatch()
        eo = moe.expert_products(p, disp, cfg)
        one = [((), {})]
        stages = {
            "router + dispatch": time_ms(route_dispatch, one, 40),
            "expert products": time_ms(
                lambda: moe.expert_products(p, disp, cfg), one, 20),
            "combine": time_ms(lambda: moe.combine(eo, order, slot, keep,
                                                   gv), one, 40),
            "moe_ffn (all)": time_ms(lambda: moe.moe_ffn(p, x, cfg), one, 20)}
        w_bytes = nbytes(p["w_gate"], p["w_up"], p["w_down"])
        b_ms = (w_bytes + nbytes(disp, eo)) / HBM_BYTES_PER_S * 1e3
        log(f"  MoE layer at {arch} width (8 rows, C={C}, {E} experts x "
            f"{m.expert_d_ff}, top-{K}, bf16): " + ", ".join(
                f"{k} {v * 1e3:.2f} us" for k, v in stages.items())
            + f"; the products' bound {b_ms * 1e3:.2f} us (bytes: "
            f"{w_bytes / 1e9:.3f} GB of expert weights) [{card}]")
        del p, disp, eo
        torch.cuda.empty_cache()


def wa_block_walls(card):
    """Wall time (host clock to a synchronise) of one decode block (T=8, 8
    rows at 160, bucket 192) at full qwen2-0.5b width, 8 layers, through
    the colocated programs and the WA backend at depths 1 and 2, bf16 and
    int8 weights + int8 KV: 3 rounds, each timing every variant once in
    turn, median per variant; with the kernels each variant launches per
    token step (torch.profiler, one block)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.core.wa import WADisaggregated
    from repro_torch.models.registry import build_model
    for label, over in (("bf16", {}),
                        ("int8 weights + int8 KV",
                         dict(weight_int8=True, kv_dtype="int8"))):
        cfg = get_config("qwen2-0.5b").replace(**over, **SHORT)
        api = build_model(cfg)
        params = api.init(0)
        impls = {"colocated": None}
        for D in (1, 2):
            impls[f"WA d{D}"] = WADisaggregated(cfg, api.device,
                                                overlap=D).decode_block
        blocks = {k: decode_block_fn(api, params, impl=v)
                  for k, v in impls.items()}
        kernels = {}
        for k, block in blocks.items():
            block()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                block()
                torch.cuda.synchronize()
            kernels[k] = sum(e.count for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA) / 8
        walls = {k: [] for k in blocks}
        for _ in range(3):
            for k, block in blocks.items():
                torch.cuda.synchronize()
                t0 = time.monotonic()
                block()
                torch.cuda.synchronize()
                walls[k].append((time.monotonic() - t0) * 1e3)
        base = float(np.median(walls["colocated"]))
        log(f"  decode block walls, {label}, median of 3 alternating: "
            + ", ".join(f"{k} {np.median(v):.2f} ms "
                        f"({np.median(v) / base:.2f}x, "
                        f"{kernels[k]:.1f} kernels a token step)"
                        for k, v in walls.items()) + f" [{card}]")
        del api, params, impls, blocks
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the recurrent families: mamba2 (SSD state, no port kernel) and
# recurrentgemma (RG-LRU state, local attention over a ring through K1, the
# GeGLU FFN through K3 in its gelu mode)
# ---------------------------------------------------------------------------

# recurrentgemma-9b: 16 query heads on one KV head of 256 (K1 in four
# launches of 4 heads); G=4 at hd 256 is one launch of 1,024 columns
RING_GROUPS = ((16, 1), (16, 4))
RING_EXTENTS = (64, 256, 2048)


def ring_inputs(dev, B, S, pair, pos, window, Hq=16, n_kv=1, hd=256,
                seed=0):
    """K1 inputs over one ring layer of S slots as the hybrid's decode
    passes them: q (B,Hq,hd) and K/V (layer 1 of a 2-layer ring cache,
    bf16/f32 or int8 with scales) in the dtype ``pair``, every row's mask
    ``slot_valid_mask(S, pos, window)`` and kv_limit min(pos + 1, S) on the
    device."""
    from repro_torch.kv.cache import slot_valid_mask
    from repro_torch.quant.int8 import quantize_kv
    g = torch.Generator(device=dev).manual_seed(seed)
    qdt, kvdt = (getattr(torch, n) for n in pair)
    q = torch.randn(B, Hq, hd, device=dev, generator=g).to(qdt)
    kf = torch.randn(2, B, n_kv, S, hd, device=dev, generator=g)
    vf = torch.randn(2, B, n_kv, S, hd, device=dev, generator=g)
    if kvdt == torch.int8:
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        k, v, ks, vs = k[1], v[1], ks[1], vs[1]
    else:
        k, v, ks, vs = kf[1].to(kvdt), vf[1].to(kvdt), None, None
    p = torch.tensor(pos, device=dev)
    mask = slot_valid_mask(S, p, window)[None].expand(B, S).contiguous()
    lim = torch.clamp_max(p + 1, S).to(torch.int32)
    return q, k, v, mask, ks, vs, lim


def phase_compare_recurrent(dev, errs):
    """K1 over the hybrid's ring at hd 256: G=16 (four launches of 4
    heads) and G=4 (one launch), B 1/2/4/8, ring extents 64/256/2,048, the
    cursor at 0 (kv_limit 1), mid-ring and at the last slot (full), and a
    wrapped ring (the model's: window = extent, every slot valid; and a
    window of 3/4 of the extent: a run of valid slots across the wrap);
    bf16 and int8 KV at every B, f32 q and KV at B 1 and 2 (phase 3's
    f32 parity); then K3 in its gelu mode at recurrentgemma's FFN (D=4096,
    F=12288) at 1, 8, 32, 128 and 1,024 rows. Tolerances as in
    ``phase_compare``; every case repeats bit for bit."""
    from repro_torch.kernels.flash_decode.ops import decode_plan
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    from repro_torch.kernels import launch_counts, reset_launch_counts
    n_cases = 0
    for Hq, n_kv in RING_GROUPS:
        for B in (1, 2, 4, 8):
            pairs = K1_PAIRS if B <= 2 else K1_PAIRS[2:]
            for S in RING_EXTENTS:
                for pair in pairs:
                    isz = torch.empty(0, dtype=getattr(torch, pair[1])) \
                        .element_size()
                    plan = decode_plan(B, n_kv, Hq // n_kv, S, 256, isz)
                    err = err_p = ratio = 0.0
                    same = True
                    for pos, window in ((0, S), (S // 2, S), (S - 1, S),
                                        (S + S // 3, S),
                                        (S + S // 3, 3 * S // 4)):
                        args = ring_inputs(dev, B, S, pair, pos, window, Hq,
                                           n_kv, seed=S + B + pos + window)
                        reset_launch_counts()
                        e, e_p, r, sm = check_k1(args, min(pos + 1, S))
                        # 2 modes x 2 calls, each ``runs`` launches
                        require(launch_counts()["flash_decode"]
                                == 4 * plan.runs, "K1 ring launches")
                        err, err_p = max(err, e), max(err_p, e_p)
                        ratio, same = max(ratio, r), same and sm
                        n_cases += 1
                    errs["flash_decode"] = max(errs["flash_decode"], err)
                    errs["flash_decode_partial"] = max(
                        errs["flash_decode_partial"], err_p)
                    log(f"  K1 ring B={B} S={S} G={Hq // n_kv} hd=256 "
                        f"q={pair[0]} kv={pair[1]} ({plan.runs} x "
                        f"{plan.heads} heads, {plan.splits} splits of "
                        f"{plan.split}, smem {plan.smem} B), cursor 0 / "
                        f"mid / last / wrapped (window S and 3S/4): "
                        f"max|d|={err:.3g} normalised, {err_p:.3g} partial,"
                        f" max|d|/tol={ratio:.3g}, repeat identical={same}")
                    require(ratio <= 1.0, f"K1 ring disagrees at B={B} "
                            f"S={S} {pair} G={Hq // n_kv}")
                    require(same, f"K1 ring not deterministic at B={B} "
                            f"S={S} {pair}")
    log(f"  K1 ring cases: {n_cases}")
    for R in (1, 8, 32, 128, 1024):
        args, _ = k3_inputs(dev, R, seed=R, D=4096, F=12288)
        got = fused_ffn(*args, act="gelu")
        want = fused_ffn_ref(*args, act="gelu")
        e, tol = max_err(got, want), 1e-4 * max(1, max_abs(want))
        same = torch.equal(fused_ffn(*args, act="gelu"), got)
        errs["fused_ffn"] = max(errs["fused_ffn"], e)
        log(f"  K3 gelu D=4096 F=12288 bf16 rows={R}: max|d|={e:.3g} "
            f"(tol {tol:.3g}), repeat identical={same}")
        require(e <= tol, f"K3 gelu disagrees at rows={R}")
        require(same, f"K3 gelu not deterministic at rows={R}")
    torch.cuda.synchronize()


def _close_steps(name, res, tol=1e-3):
    """CPU against CUDA (``res``: the card's records, then the CPU's) for
    each recorded program: its values (the logits of every step; the state
    of the decode block) within ``tol`` of their largest magnitude, tokens
    equal."""
    for key in res[1]:
        lc, tc = res[1][key]
        lg, tg = res[0][key]
        rel = rel_err(lg, lc)
        same = torch.equal(tc, tg)
        log(f"  {name} {key}: max|d|/max = {rel:.3g} (tol {tol:g}) over "
            f"{lc.shape[0]} step(s), tokens equal={same}")
        require(np.isfinite(rel) and rel <= tol and same,
                f"{name} {key}: cpu and cuda disagree")


def parity_ssm(cfg, devs=("cuda", "cpu")):
    """mamba2 (SSD) CPU against CUDA on the same seeded f32 weights (made
    on the first device, copied): monolithic prefill of 4 prompts of 40;
    a 40-token prompt in 3 chunks of 16 (16, 16, 8) into slot 2 of a fresh
    state; 6 slotted steps from the prefilled state with row 3 inactive
    (its state must keep its bytes); the decode block (T=4)."""
    from repro_torch.interop import to_device
    from repro_torch.models.registry import build_model
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 40), dtype=np.int64))
    src = to_device(build_model(cfg, device=devs[0]).init(0), "cpu")
    res = []
    for d in devs:
        api = build_model(cfg, device=d)
        params = to_device(src, api.device)
        r = {}
        res.append(r)
        st, lg = api.prefill(params, prompts.to(d))
        first = lg[:, -1].argmax(-1).to(torch.int32)
        r["prefill"] = (lg[:, -1].float().cpu()[None], first.cpu()[None])
        cst = api.init_caches(4, 64)
        out = []
        for start in (0, 16, 32):
            n = min(16, 40 - start)
            row = torch.zeros((1, 16), dtype=torch.long)
            row[0, :n] = prompts[2, start:start + n]
            cst, lc = api.prefill_chunk(params, cst, row.to(d), 2, start, n)
            out.append(lc[:, -1].float().cpu())
        r["chunked"] = (torch.stack(out), torch.stack(out).argmax(-1))
        ch_rel = rel_err(cst.h[:, 2].float().cpu(), st.h[:, 2].float().cpu())
        log(f"  mamba2 on {d}: chunked (16+16+8) state against the "
            f"monolithic prefill's: max|d|/max = {ch_rel:.3g}")
        require(ch_rel <= 1e-3, "chunked SSD state differs from prefill")
        blk_state = type(st)(st.h.clone(), st.conv.clone())
        act = torch.tensor([True, True, True, False], device=d)
        keep = (st.h[:, 3].clone(), st.conv[:, 3].clone())
        tok, pos = first, torch.full((4,), 40, dtype=torch.int32, device=d)
        logits, toks = [], []
        for _ in range(6):
            st, lg = api.decode_slotted(params, st, tok, pos, act)
            logits.append(lg[:3, 0].float().cpu())
            tok = torch.where(act, lg[:, 0].argmax(-1).to(torch.int32), 0)
            toks.append(tok[:3].cpu())
            pos = pos + act.to(torch.int32)
        kept = torch.equal(st.h[:, 3], keep[0]) \
            and torch.equal(st.conv[:, 3], keep[1])
        log(f"  mamba2 on {d}: inactive row's state kept its bytes through "
            f"6 slotted steps: {kept}")
        require(kept, f"mamba2 slotted decode wrote an inactive row on {d}")
        r["slotted"] = (torch.stack(logits), torch.stack(toks))
        blk = api.decode_block(
            params, blk_state, first, torch.full((4,), 40, dtype=torch.int32,
                                                 device=d),
            torch.ones(4, dtype=torch.bool, device=d),
            torch.full((4,), 4, dtype=torch.int32, device=d),
            torch.full((4,), -1, dtype=torch.int32, device=d), block_size=4)
        # the block's state and tokens (T, B)
        r["block"] = (blk_state.h.float().cpu()[None], blk[1].cpu())
    _close_steps("mamba2", res)


def parity_hybrid(cfg, devs=("cuda", "cpu"), prompt=96, steps=48):
    """recurrentgemma CPU against CUDA: prefill of 2 prompts longer than
    the window (the ring rolls), then ``steps`` shared-cursor decode steps
    that wrap the ring, logits compared at every step."""
    from repro_torch.interop import to_device
    from repro_torch.models.registry import build_model
    prompts = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, prompt), dtype=np.int64))
    src = to_device(build_model(cfg, device=devs[0]).init(0), "cpu")
    res = []
    for d in devs:
        t0 = time.monotonic()
        api = build_model(cfg, device=d)
        params = to_device(src, api.device)
        caches, lg = api.prefill(params, prompts.to(d))
        size = caches["kv"].k.shape[3]
        logits, toks = [lg[:, -1].float().cpu()], []
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        toks.append(tok.cpu())
        for _ in range(steps):
            caches, lg = api.decode(params, caches, tok)
            logits.append(lg[:, 0].float().cpu())
            tok = lg[:, 0].argmax(-1).to(torch.int32)
            toks.append(tok.cpu())
        length = int(caches["kv"].length)
        res.append({"prefill+decode": (torch.stack(logits),
                                       torch.stack(toks))})
        log(f"  recurrentgemma on {d}: ring of {size} slots (window "
            f"{cfg.rglru.window}), prompt {prompt}, {steps} steps to "
            f"length {length} ({time.monotonic() - t0:.1f}s)")
        require(length > size + prompt % size and prompt > size,
                "the ring did not roll and wrap")
    _close_steps("recurrentgemma", res)


def phase_parity_recurrent():
    import dataclasses
    from repro_torch.configs.registry import get_config
    t0 = time.monotonic()
    parity_ssm(get_config("mamba2-1.3b").replace(n_layers=2,
                                                 dtype="float32"))
    log(f"  mamba2 parity (full width, 2 layers, f32) took "
        f"{time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    cfg = get_config("recurrentgemma-9b")
    cfg = cfg.replace(n_layers=4, dtype="float32", vocab_size=32000,
                      rglru=dataclasses.replace(cfg.rglru, window=64))
    parity_hybrid(cfg)
    log(f"  recurrentgemma parity (full width, 4 layers: one superblock "
        f"and one tail layer, window cut to 64, vocabulary cut to 32,000 "
        f"of 256,000 for the CPU side, f32) took "
        f"{time.monotonic() - t0:.1f}s")


# phase 4's recurrent runs: (o) mamba2 at full width, 6 of 48 layers, on
# (a)'s plan (no port kernel: the SSD has none, the reference never quantizes
# its projections); (p) recurrentgemma at full width, 6 of 38 layers, mode
# "auto", which resolves to drain (no slotted API), 8 slots, prompt 128,
# 12 x 32 tokens: K1 over the ring (256 slots: min(window, 128 + 128)) and
# K3 in its gelu mode
RECURRENT_RUNS = {
    # name: (arch, config overrides, engine kwargs, n_requests, max_new,
    #        kernels); (o) at 24 of mamba2's 48 layers since the training
    # run (s) joined the script, 12 since the mesh phase 4b did, 6 since
    # the training mesh phase 4c did; (p) at 19 of recurrentgemma's 38 (6
    # superblocks and a tail layer) since phase 4c did, 12 (4 superblocks)
    # since phase 4d did, 6 (2 superblocks) since phase 4e did
    "o_mamba2_chunked_T8": (
        "mamba2-1.3b", dict(n_layers=6), RUNS["a_bf16_chunked_T8"][1], 12,
        64, ()),
    "p_recurrentgemma_auto_drain": (
        "recurrentgemma-9b", dict(n_layers=6),
        dict(mode="auto", max_new_cap=72), 12, 32,
        ("flash_decode", "fused_ffn")),
}


def rehearse_host_syncs(arch, kw, n_req, max_new) -> int:
    """Host syncs of the same plan on the CPU at the reduced config: they
    depend on the plan alone (no stop ids)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serving import ServingEngine
    cfg = get_config(arch).reduced()
    api = build_model(cfg, device="cpu")
    eng = ServingEngine(api, 8, 128, device="cpu", **kw)
    stats = eng.run(api.init(0), make_requests(cfg, n_req, 128, max_new,
                                               seed=0, arrival_every=4))
    require(stats["completed"] == n_req, "CPU rehearsal incomplete")
    return stats["host_syncs"]


def trace_drain_steps(api, params, n_steps=3, B=8, S=128, prefill=None):
    """Profile ``n_steps`` shared-cursor decode steps after a batch
    prefill of B x S (drain serving; ``prefill(tokens)`` when given, else
    the model's): synchronising calls (counted on untraced steps), kernels
    per token step, device busy time and idle share. Returns the
    synchronising calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = api.device
    toks = torch.randint(0, api.config.vocab_size, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    caches, lg = (prefill or (lambda t: api.prefill(params, t)))(toks)
    tok = lg[:, -1].argmax(-1).to(torch.int32)

    def steps(n):
        nonlocal caches, tok
        for _ in range(n):
            caches, lg = api.decode(params, caches, tok)
            tok = lg[:, 0].argmax(-1).to(torch.int32)

    steps(1)
    torch.cuda.synchronize()
    syncs = count_syncs(lambda: steps(n_steps))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    steps(n_steps)
    torch.cuda.synchronize()
    wall_plain = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(n_steps)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kern)
    log(f"    synchronising calls inside {n_steps} drain decode steps: "
        f"{syncs}")
    if busy_us <= 0:
        log("    trace: profiler reported no device time (idle share not "
            "measured)")
        return syncs
    n_kern = sum(e.count for e in kern)
    log(f"    trace of {n_steps} drain decode steps ({B} rows, cursor "
        f"{S + 1}): untraced wall {wall_plain * 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms in {n_kern} kernels "
        f"({n_kern / n_steps:.1f} per token step), idle share "
        f"{1 - busy_us / 1e3 / (wall_plain * 1e3):.3f} of the untraced "
        f"wall")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"      {e.key[:64]:64s} {e.self_device_time_total / 1e3:8.3f} "
            f"ms, {e.count} launches")
    port = {}
    for e in kern:
        for tag in ("flash_decode", "gate_up_kernel", "down_kernel"):
            if tag in e.key:
                us, n = port.get(tag, (0.0, 0))
                port[tag] = (us + e.self_device_time_total, n + e.count)
    log("      port kernels: " + ", ".join(
        f"{k} {us / 1e3:.3f} ms in {n} launches"
        for k, (us, n) in port.items()))
    return syncs


def phase_engine_recurrent(totals, runs, per_step, host_syncs_a):
    """Runs (o) and (p) (``RECURRENT_RUNS``), seeded random bf16 weights.
    (o): every request completes, no port kernel launches (the counts
    stay 0: the path's truth), the host syncs equal the CPU rehearsal's
    of the same plan, and one decode-block program serves (no buckets);
    one decode block is traced. (p): ``auto`` resolves to drain, every
    request completes, no request is admitted while another decodes, K1
    and K3 launch and K4 does not; three drain decode steps are traced.
    The traced steps make no synchronising call."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serving import ServingEngine
    syncs = {}
    for name, (arch, over, kw, n_req, max_new, needed) in \
            RECURRENT_RUNS.items():
        t_run = time.monotonic()
        cfg = get_config(arch).replace(**over)
        t0 = time.monotonic()
        api = build_model(cfg)
        params = api.init(0)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        reqs = make_requests(cfg, n_req, 128, max_new, seed=0,
                             arrival_every=4)
        eng = ServingEngine(api, 8, 128, **kw)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.monotonic()
        stats = eng.run(params, reqs)
        torch.cuda.synchronize()
        serve_s = time.monotonic() - t0
        counts = launch_counts()
        runs[name] = counts
        for k, n in counts.items():
            totals[k] += n
        stats.pop("per_request")
        runtime = stats.pop("runtime")
        log(f"  run {name}: {arch} x {cfg.n_layers} layers, init "
            f"{init_s:.1f}s, serve {serve_s:.1f}s, launches {counts}")
        log(f"    stats: {json.dumps(stats)}")
        log(f"    programs: " + ", ".join(
            f"{k}={v['calls']}" for k, v in runtime.items() if v["calls"]))
        log(f"    decode TPOT mean {stats['tpot_mean_ms']:.3f} ms, p50 "
            f"{stats['tpot_p50_ms']:.3f} ms, p99 {stats['tpot_p99_ms']:.3f} "
            f"ms; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        require(stats["completed"] == n_req, f"{name}: not all completed")
        for r in reqs:
            require(len(r.generated) == max_new and all(
                0 <= t < cfg.vocab_size for t in r.generated),
                f"{name}: request {r.rid} stream malformed")
        require(all((n > 0) == (k in needed) for k, n in counts.items()),
                f"{name}: launches {counts}, its path's kernels {needed}")
        if cfg.family == "ssm":
            want = rehearse_host_syncs(arch, kw, n_req, max_new)
            log(f"    host syncs {stats['host_syncs']} (the same plan on "
                f"the CPU at the reduced config: {want}; run (a): "
                f"{host_syncs_a})")
            require(stats["host_syncs"] == want,
                    f"{name}: another number of host syncs than the plan")
            blocks = [k for k in runtime if k.startswith("serve_decode_block")]
            require(blocks == ["serve_decode_block"] and eng._ex.buckets
                    == (0,), f"{name}: decode-block programs {blocks}")
            syncs[name] = trace_decode_block(api, params, kw)
            caches = api.init_caches(8, 200)
            z = torch.zeros(8, dtype=torch.int32, device=api.device)
            on = torch.ones(8, dtype=torch.bool, device=api.device)
            reset_launch_counts()
            api.decode_slotted(params, caches, z, z + 100, on)
        else:
            require(eng.mode == stats["mode"] == "drain",
                    f"{name}: auto resolved to {eng.mode}")
            log(f"    drain admission groups (step: rids): "
                f"{drain_groups(reqs)}")
            syncs[name] = trace_drain_steps(api, params)
            caches, lg = api.prefill(params, torch.zeros(
                (8, 128), dtype=torch.long, device=api.device))
            reset_launch_counts()
            api.decode(params, caches, lg[:, -1].argmax(-1))
        torch.cuda.synchronize()
        per_step[name] = {k: n for k, n in launch_counts().items() if n}
        log(f"    launches of one decode step: {per_step[name]}")
        del params, eng, api
        torch.cuda.empty_cache()
        log(f"    run {name} took {time.monotonic() - t_run:.1f}s")
    require(all(n == 0 for n in syncs.values()),
            f"a traced recurrent step synchronises with the host: {syncs}")
    return syncs


def recurrent_timing_rows(dev, bound, sdpa_args):
    """Phase 5 rows of the recurrent families: K1 at run (p)'s shape (B=8,
    16 query heads on one KV head of 256, ring 256 and 2,048, bf16 KV,
    every slot live) against SDPA with ``enable_gqa``; K3 gelu at
    D=4096 F=12288 at 8 and 1,024 rows against three matmuls and gelu;
    and, for the record, one SSD decode layer of mamba2 and one RG-LRU
    residual block of recurrentgemma at 8 rows (plain PyTorch: their
    device and host time and kernels a call)."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    rows = []
    for S in (256, 2048):
        def make(i, S=S):
            return ring_inputs(dev, 8, S, ("bfloat16", "bfloat16"), S - 1,
                               S, seed=i), {}
        q, k, v, mask, ks, vs, lim = make(0)[0]
        nb = nbytes(q, k, v, mask) + q.numel() * 4
        b_ms, b_by = bound(nb, 4 * 8 * 16 * S * 256, torch.bfloat16)
        var = variants_of(make, nb)
        lib = {"sdpa(enable_gqa)": time_ms(F.scaled_dot_product_attention,
                                           sdpa_args(var), 400)}
        rows.append(("flash_decode", f"recurrentgemma ring, G=16 (4 "
                     f"launches of 4 heads): B=8 Hq=16 n_kv=1 hd=256 "
                     f"S={S} kv=bfloat16", time_ms(flash_decode, var, 400),
                     time_ms(flash_decode_ref, var, 50), b_ms, b_by, lib,
                     host_ms(flash_decode, var)))
    for R in (8, 1024):
        (x, wg, wu, wd), _ = k3_inputs(dev, R, D=4096, F=12288)
        nb = nbytes(x, wg, wu, wd) + R * 4096 * 4
        b_ms, b_by = bound(nb, 2 * R * 4096 * 12288 * 3, torch.bfloat16)

        def make(i, R=R):
            args, _ = k3_inputs(dev, R, seed=i, D=4096, F=12288)
            return args, dict(act="gelu")
        var = variants_of(make, nb)

        def lib_ffn(x, wg, wu, wd, act="gelu"):
            return torch.matmul(F.gelu(torch.matmul(x, wg),
                                       approximate="tanh")
                                * torch.matmul(x, wu), wd)
        lib = {"3x torch.matmul + gelu (bf16)": time_ms(lib_ffn, var, 100)}
        rows.append(("fused_ffn", f"recurrentgemma GeGLU FFN: rows={R} "
                     f"D=4096 F=12288 bf16 gelu",
                     time_ms(fused_ffn, var, 100),
                     time_ms(fused_ffn_ref, var, 20), b_ms, b_by, lib,
                     host_ms(fused_ffn, var)))
    # the recurrent layers themselves, plain PyTorch, at 8 decode rows
    from repro_torch.models import rglru, ssm
    from repro_torch.models.registry import build_model
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        cfg = get_config(arch).replace(n_layers=1)  # hybrid: one tail layer
        api = build_model(cfg)
        params = api.init(0)
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(8, 1, cfg.d_model, device=dev, generator=g).to(
            torch.bfloat16)
        if cfg.family == "ssm":
            lp = params["blocks"][0]["ssd"]
            st = api.init_caches(8, 0)
            h, c = st.h[0], st.conv[0]
            fn = lambda x, h, c: ssm.ssd_decode(lp, x, cfg, h, c)  # noqa
            what = "one SSD decode layer (mamba2, 8 rows)"
            state_b = nbytes(h, c)
        else:
            lp = params["tail"][0]
            st = api.init_caches(8, 256)["state"]
            h, c = st.h[0], st.conv[0]
            fn = lambda x, h, c: rglru._mix_residual(  # noqa
                lp, x, cfg, (h, c))
            what = ("one RG-LRU residual block (recurrentgemma: mix + GeGLU "
                    "FFN through K3, 8 rows)")
            state_b = nbytes(h, c)
        w_b = sum(t.numel() * t.element_size() for t in _leaves(lp))
        var = [((x, h, c), {})]
        ms = time_ms(fn, var, 40)
        host = host_ms(fn, var, 20)
        b_ms = (w_b + 2 * state_b) / HBM_BYTES_PER_S * 1e3
        log(f"  {what}: {ms * 1e3:.2f} us device, {host * 1e3:.2f} us host "
            f"a call, {count_kernels(fn, var[0])} kernels; weights "
            f"{w_b / 1e6:.1f} MB + state {state_b / 1e6:.2f} MB read and "
            f"written: bound {b_ms * 1e3:.2f} us (bytes)")
        del params, api
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the VLM (internvl2's backbone: K1 at 64 query heads on 8 KV heads of 128,
# K3 at D=8,192 F=28,672) and the enc-dec family (whisper: K1 at 16 query
# heads on 16 KV heads of 64 over the self cache and the cross K/V of 1,500
# frames, K4 at its linears with int8 weights; its gelu_mlp has no kernel)
# ---------------------------------------------------------------------------

WHISPER_K1 = dict(Hq=16, n_kv=16, hd=64)
INTERNVL2_K1 = dict(Hq=64, n_kv=8, hd=128)
WHISPER_K4 = ((1024, 1024), (1024, 4096), (4096, 1024))
INTERNVL2_FFN = dict(D=8192, F=28672)


def phase_compare_vlm_encdec(dev, errs):
    """K1 at G=1, hd 64, 16 KV heads, B 1/2/8: the cross-attention over
    1,500 frames (all-true mask, the limit at the last frame, as
    ``encdec.decode_step`` passes it; bf16 and f32) and the self
    cache at extents 160 and 288 (prompt + 128) with kv_limit at 0, inside
    a split, on a split edge and at S (bf16 and int8 KV); K3 at internvl2's
    D=8,192 F=28,672 at 1, 8, 128 and 768 rows in bf16 and at phase 3's
    f32 prefill of 576 rows (32-row tiles); K4 at whisper's 1024x1024,
    1024x4096 and 4096x1024 at 1, 2, 4 and 8 rows (bit-exact). Tolerances
    as in ``phase_compare``; every case repeats bit for bit."""
    from repro_torch.kernels.flash_decode.ops import decode_plan
    from repro_torch.kernels.fused_ffn.ops import ffn_plan, fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    from repro_torch.kernels.gemv.ops import gemv_int8_q
    from repro_torch.kernels.gemv.ref import gemv_int8_ref
    cases = [(B, 1500, pair, True) for B in (1, 2, 8)
             for pair in (("bfloat16", "bfloat16"), ("float32", "float32"))]
    cases += [(B, S, pair, False) for B in (1, 2, 8) for S in (160, 288)
              for pair in (("bfloat16", "bfloat16"), ("bfloat16", "int8"))]
    for B, S, pair, cross in cases:
        isz = torch.empty(0, dtype=getattr(torch, pair[1])).element_size()
        plan = decode_plan(B, 16, 1, S, 64, isz)
        edge = plan.split if plan.splits > 1 else S
        # None: every position live, kv_limit S (the cross-attention's)
        lims = [None] if cross else \
            sorted({0, max(1, plan.split // 2 + 3), edge, S}) + [None]
        err = err_p = ratio = 0.0
        same = True
        for lim in lims:
            args = k1_inputs(dev, B, S, pair, lim, seed=S + B + (lim or 0),
                             **WHISPER_K1)
            e, e_p, r, sm = check_k1(args, S if lim is None else lim)
            err, err_p = max(err, e), max(err_p, e_p)
            ratio, same = max(ratio, r), same and sm
        errs["flash_decode"] = max(errs["flash_decode"], err)
        errs["flash_decode_partial"] = max(errs["flash_decode_partial"],
                                           err_p)
        what = "cross, all-true mask, kv_limit S" if cross \
            else f"self, kv_limit {lims[:-1]} and every row live"
        log(f"  K1 whisper B={B} S={S} G=1 hd=64 n_kv=16 q={pair[0]} "
            f"kv={pair[1]} ({plan.runs} x {plan.heads} heads, "
            f"{plan.splits} splits of {plan.split}, smem {plan.smem} B), "
            f"{what}: max|d|={err:.3g} normalised, {err_p:.3g} partial, "
            f"max|d|/tol={ratio:.3g}, repeat identical={same}")
        require(ratio <= 1.0, f"K1 whisper disagrees at B={B} S={S} {pair}")
        require(same, f"K1 whisper not deterministic at B={B} S={S}")
    for R, dtype in ((1, torch.bfloat16), (8, torch.bfloat16),
                     (128, torch.bfloat16), (768, torch.bfloat16),
                     (576, torch.float32)):
        args, _ = k3_inputs(dev, R, seed=R, dtype=dtype, **INTERNVL2_FFN)
        plan = ffn_plan(R, 8192, 28672, args[0].element_size())
        got = fused_ffn(*args)
        want = fused_ffn_ref(*args)
        e, tol = max_err(got, want), 1e-4 * max(1, max_abs(want))
        same = torch.equal(fused_ffn(*args), got)
        errs["fused_ffn"] = max(errs["fused_ffn"], e)
        log(f"  K3 internvl2 D=8192 F=28672 {str(dtype)[6:]} rows={R} "
            f"({plan.rows}-row tiles, {plan.d_splits} D chunks, "
            f"{plan.f_splits} F chunks, scratch "
            f"{plan.scratch * 4 / 2 ** 30:.2f} GiB): max|d|={e:.3g} "
            f"(tol {tol:.3g}), repeat identical={same}")
        require(e <= tol, f"K3 internvl2 disagrees at rows={R} {dtype}")
        require(same, f"K3 internvl2 not deterministic at rows={R}")
        del args, got, want
    torch.cuda.empty_cache()
    for K, N in WHISPER_K4:
        for R in (1, 2, 4, 8):
            args, _ = k4_inputs(dev, R, K, N, seed=K + N + R)
            got = gemv_int8_q(*args)
            exact = torch.equal(got, gemv_int8_ref(*args))
            same = torch.equal(gemv_int8_q(*args), got)
            log(f"  K4 whisper K={K} N={N} rows={R}: exact={exact}, "
                f"repeat identical={same}")
            require(exact and same, f"K4 not exact at {K}x{N} rows={R}")
    torch.cuda.synchronize()


def _caches_close(name, a, b, tol=1e-3):
    """Two sides' caches (the card's, then the CPU's, as dicts of named
    tensors on the CPU): float tensors within ``tol`` of their largest
    magnitude; int8 bytes counted where they differ, each by one step at
    most and in at most 1e-3 of them."""
    for key in b:
        x, y = a[key], b[key]
        if x.dtype == torch.int8:
            d = (x.int() - y.int()).abs()
            n = int((d > 0).sum())
            log(f"  {name} cache {key}: {n} of {y.numel()} int8 bytes differ"
                f" (max step {int(d.max())})")
            require(int(d.max()) <= 1 and n <= 1e-3 * y.numel(),
                    f"{name} cache {key}: cpu and cuda disagree")
        else:
            rel = rel_err(x.float(), y.float())
            log(f"  {name} cache {key}: max|d|/max = {rel:.3g} (tol {tol:g})")
            require(np.isfinite(rel) and rel <= tol,
                    f"{name} cache {key}: cpu and cuda disagree")


def parity_encdec(cfg, B=2, prompt=16, steps=16, devs=("cuda", "cpu")):
    """whisper CPU against CUDA on the same seeded weights (made on the
    card, copied): prefill with seeded frames, then ``steps`` decode
    steps; logits at every step and tokens (``_close_steps``), then the
    self cache (values, or int8 bytes and scales) and the cross K/V. With
    int8 weights the card runs first and records its quantized
    activations, and the CPU multiplies the card's (``recorded_act_quant``
    with ``replay``): both sides' K4 then see the same int8 inputs; the
    flips are counted."""
    from repro_torch.interop import to_device
    from repro_torch.models.registry import build_model
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, prompt)))
    frames = torch.from_numpy(rng.standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
    src = to_device(build_model(cfg, device=devs[0]).init(0), "cpu")
    res, caches_out, recs = [], [], []
    for d in devs:
        t0 = time.monotonic()
        api = build_model(cfg, device=d)
        params = to_device(src, api.device)
        rows = []
        ctx = recorded_act_quant(rows, recs[0] if recs else None) \
            if cfg.weight_int8 else contextlib.nullcontext()
        with ctx:
            caches, lg = api.prefill(params, toks.to(d), frames.to(d))
            logits, out = [lg[:, -1].float().cpu()], []
            tok = lg[:, -1].argmax(-1).to(torch.int32)
            out.append(tok.cpu())
            for _ in range(steps):
                caches, lg = api.decode(params, caches, tok)
                logits.append(lg[:, 0].float().cpu())
                tok = lg[:, 0].argmax(-1).to(torch.int32)
                out.append(tok.cpu())
        recs.append(rows)
        res.append({"prefill+decode": (torch.stack(logits),
                                       torch.stack(out))})
        s = caches["self"]
        caches_out.append({
            **{f"self.{f}": getattr(s, f).cpu() for f in
               ("k", "v", "k_scale", "v_scale") if getattr(s, f) is not None},
            "cross.k": caches["cross"]["k"].cpu(),
            "cross.v": caches["cross"]["v"].cpu()})
        log(f"  whisper on {d}: {cfg.encoder.n_layers} encoder + "
            f"{cfg.n_layers} decoder layers, {cfg.encoder.n_frames} frames, "
            f"prompt {prompt}, {steps} steps, self cache {tuple(s.k.shape)} "
            f"{s.k.dtype} ({time.monotonic() - t0:.1f}s)")
        del params, api, caches
    if cfg.weight_int8:
        log(f"  whisper int8 weights: {len(recs[0])} activation "
            f"quantizations, the CPU's own rounding differs from the card's "
            f"in {int8_flips(recs[0], recs[1])} elements (replayed)")
    _close_steps("whisper", res)
    _caches_close("whisper", *caches_out)


def parity_vlm(cfg, B=2, prompt=32, steps=16, devs=("cuda", "cpu")):
    """internvl2 CPU against CUDA on the same seeded weights: prefill of
    ``n_vision_tokens`` seeded vision embeddings before a ``prompt``-token
    text, then ``steps`` shared-cursor decode steps; logits at every step,
    tokens, and the cache."""
    from repro_torch.interop import to_device
    from repro_torch.models.registry import build_model
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, prompt)))
    vis = torch.from_numpy(rng.standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    src = to_device(build_model(cfg, device=devs[0]).init(0), "cpu")
    res, caches_out = [], []
    for d in devs:
        t0 = time.monotonic()
        api = build_model(cfg, device=d)
        params = to_device(src, api.device)
        caches, lg = api.prefill(params, toks.to(d), vision_embeds=vis.to(d))
        logits, out = [lg[:, -1].float().cpu()], []
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        out.append(tok.cpu())
        for _ in range(steps):
            caches, lg = api.decode(params, caches, tok)
            logits.append(lg[:, 0].float().cpu())
            tok = lg[:, 0].argmax(-1).to(torch.int32)
            out.append(tok.cpu())
        res.append({"prefill+decode": (torch.stack(logits),
                                       torch.stack(out))})
        caches_out.append({"k": caches.k.cpu(), "v": caches.v.cpu()})
        log(f"  internvl2 on {d}: {cfg.n_layers} layers, "
            f"{cfg.n_vision_tokens} vision + {prompt} text positions, "
            f"{steps} steps to length {int(caches.length)} "
            f"({time.monotonic() - t0:.1f}s)")
        require(int(caches.length) == cfg.n_vision_tokens + prompt + steps,
                "internvl2 cache length")
        del params, api, caches
    _close_steps("internvl2", res)
    _caches_close("internvl2", *caches_out)


def phase_parity_vlm_encdec():
    from repro_torch.configs.registry import get_config
    t0 = time.monotonic()
    base = get_config("whisper-medium")
    for over in (dict(dtype="float32"),
                 dict(dtype="float32", weight_int8=True, kv_dtype="int8")):
        cfg = base.replace(n_layers=2, encoder=dataclasses.replace(
            base.encoder, n_layers=2), **over)
        parity_encdec(cfg)
    log(f"  whisper parity (full width, 2 + 2 layers, 1,500 frames, f32; "
        f"int8 weights + int8 KV) took {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    parity_vlm(get_config("internvl2-76b").replace(
        n_layers=2, dtype="float32", vocab_size=32000))
    log(f"  internvl2 parity (full width, 2 layers, vocabulary cut to "
        f"32,000 of 128,256 for the CPU side, 256 vision embeddings, f32) "
        f"took {time.monotonic() - t0:.1f}s")


# run (q): internvl2-76b at full width, depth cut to 4 of 80 layers (8
# until phase 4d joined; 80 layers would be ~141 GB), served text-only as the
# reference engine serves the family: ``auto`` resolves to continuous with
# monolithic admission (the family has no chunk lane) on (a)'s plan
# otherwise (8 slots, prompt 128, 12 x 64 tokens arriving every 4 steps,
# T=8, KV buckets of 64): K1 and K3, never K4. Run (r): whisper-medium at
# full width and depth (24 + 24 layers, ~1.6 GB) at the model level
# (the engine refuses the family): 8 rows, 1,500 seeded frames, prompt 32,
# 64 greedy steps through ``api.decode``: K1 48 times a step, no K3
VLM_RUN = ("q_internvl2_4L_monolithic_T8", "internvl2-76b",
           dict(n_layers=4), dict(block_size=8, kv_bucket_chunk=64,
                                  max_new_cap=72), 12, 64,
           ("flash_decode", "fused_ffn"))
# (r) at 12 + 12 of whisper's 24 + 24 layers since phase 4c joined
ENCDEC_RUN = ("r_whisper_model_level_64_steps", "whisper-medium", 8, 32, 64)
ENCDEC_LAYERS = 12


def phase_engine_vlm_encdec(totals, runs, per_step):
    """Runs (q) and (r), seeded random bf16 weights. (q): every request
    completes with a well-formed stream, ``auto`` resolves to continuous
    with monolithic admission, K1 and K3 launch (each once a layer in one
    decode step) and K4 never, and the host syncs equal the CPU
    rehearsal's of the same plan; one decode block is traced. (r): the
    prefill with frames, then 64 decode steps with exactly 2 K1 launches
    a decoder layer a step and no K3 or K4, tokens in the vocabulary; ms
    a step; three decode steps are traced. The traced steps make no
    synchronising call."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serving import ServingEngine
    syncs = {}
    name, arch, over, kw, n_req, max_new, needed = VLM_RUN
    cfg = get_config(arch).replace(**over)
    t0 = time.monotonic()
    api = build_model(cfg)
    params = api.init(0)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    reqs = make_requests(cfg, n_req, 128, max_new, seed=0, arrival_every=4)
    eng = ServingEngine(api, 8, 128, **kw)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.monotonic()
    stats = eng.run(params, reqs)
    torch.cuda.synchronize()
    serve_s = time.monotonic() - t0
    counts = launch_counts()
    runs[name] = counts
    for k, n in counts.items():
        totals[k] += n
    stats.pop("per_request")
    runtime = stats.pop("runtime")
    log(f"  run {name}: {arch} x {cfg.n_layers} layers, init {init_s:.1f}s, "
        f"serve {serve_s:.1f}s, launches {counts}")
    log(f"    stats: {json.dumps(stats)}")
    log(f"    programs: " + ", ".join(
        f"{k}={v['calls']}" for k, v in runtime.items() if v["calls"]))
    log(f"    decode TPOT mean {stats['tpot_mean_ms']:.3f} ms, p50 "
        f"{stats['tpot_p50_ms']:.3f} ms, p99 {stats['tpot_p99_ms']:.3f} ms; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    require(stats["completed"] == n_req, f"{name}: not all completed")
    for r in reqs:
        require(len(r.generated) == max_new and all(
            0 <= t < cfg.vocab_size for t in r.generated),
            f"{name}: request {r.rid} stream malformed")
    require(eng.mode == stats["mode"] == "continuous"
            and stats["prefill_mode"] == "monolithic",
            f"{name}: served {stats['mode']}/{stats['prefill_mode']}")
    require(all((n > 0) == (k in needed) for k, n in counts.items()),
            f"{name}: launches {counts}, its path's kernels {needed}")
    want = rehearse_host_syncs(arch, kw, n_req, max_new)
    log(f"    host syncs {stats['host_syncs']} (the same plan on the CPU at "
        f"the reduced config: {want})")
    require(stats["host_syncs"] == want,
            f"{name}: another number of host syncs than the plan")
    syncs[name] = trace_decode_block(api, params, kw)
    caches = api.init_caches(8, 200)
    z = torch.zeros(8, dtype=torch.int32, device=api.device)
    reset_launch_counts()
    api.decode_slotted(params, caches, z, z + 100, z == 0, kv_bucket=128)
    torch.cuda.synchronize()
    per_step[name] = {k: n for k, n in launch_counts().items() if n}
    log(f"    launches of one decode step: {per_step[name]}")
    require(per_step[name] == {"flash_decode": cfg.n_layers,
                               "fused_ffn": cfg.n_layers},
            f"{name}: one decode step launched {per_step[name]}")
    del params, eng, api, caches
    torch.cuda.empty_cache()

    name, arch, B, prompt, steps = ENCDEC_RUN
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=ENCDEC_LAYERS, encoder=dataclasses.replace(
        cfg.encoder, n_layers=ENCDEC_LAYERS))
    t0 = time.monotonic()
    api = build_model(cfg)
    params = api.init(0)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    g = torch.Generator(device=api.device).manual_seed(0)
    frames = torch.randn(B, cfg.encoder.n_frames, cfg.d_model,
                         device=api.device, generator=g)
    toks = torch.randint(0, cfg.vocab_size, (B, prompt), device=api.device,
                         generator=g)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    caches, lg = api.prefill(params, toks, frames)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    tok = lg[:, -1].argmax(-1).to(torch.int32)
    out = [tok]
    reset_launch_counts()
    t0 = time.monotonic()
    for _ in range(steps):
        caches, lg = api.decode(params, caches, tok)
        tok = lg[:, 0].argmax(-1).to(torch.int32)
        out.append(tok)
    torch.cuda.synchronize()
    step_ms = (time.monotonic() - t0) / steps * 1e3
    counts = launch_counts()
    runs[name] = counts
    for k, n in counts.items():
        totals[k] += n
    out = torch.stack(out).cpu()
    log(f"  run {name}: {arch} x {cfg.encoder.n_layers} + {cfg.n_layers} "
        f"layers, {B} rows, {cfg.encoder.n_frames} frames, prompt {prompt}: "
        f"init {init_s:.1f}s, prefill {prefill_s * 1e3:.1f} ms, {steps} "
        f"decode steps at {step_ms:.3f} ms a step (host clock, one "
        f"synchronise at the end), launches {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; first "
        f"row's tokens {out[:12, 0].tolist()}")
    require(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
            f"{name}: tokens outside the vocabulary")
    require(counts == {"flash_decode": 2 * cfg.n_layers * steps,
                       "flash_decode_partial": 0, "fused_ffn": 0,
                       "gemv_int8": 0},
            f"{name}: launches {counts}, want K1 {2 * cfg.n_layers} a step")
    require(int(caches["self"].length) == prompt + steps,
            f"{name}: self cache length")
    per_step[name] = {"flash_decode": 2 * cfg.n_layers}
    syncs[name] = trace_drain_steps(
        api, params, B=B, S=prompt,
        prefill=lambda t: api.prefill(params, t, frames))
    del params, api, caches, frames
    torch.cuda.empty_cache()
    require(all(n == 0 for n in syncs.values()),
            f"a traced step of (q) or (r) synchronises with the host: "
            f"{syncs}")
    return syncs


def vlm_encdec_timing_rows(dev, bound, sdpa_args):
    """Phase 5 rows of the VLM and enc-dec families: K1 at whisper's
    cross-attention (B=8, 16 heads on 16 KV heads of 64, S=1,500 frames,
    bf16, all-true mask, the limit at S) and at internvl2's decode shape
    (B=8, 64 heads on 8 KV heads of 128, S=200, bf16, every position
    live), each against SDPA with ``enable_gqa``; K3 at internvl2's FFN
    (D=8,192 F=28,672, bf16) at 8 and 384 rows against three matmuls and
    silu."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    rows = []
    for label, S, shape in (
            ("whisper cross-attention, G=1: B=8 Hq=16 n_kv=16 hd=64 "
             "S=1500 kv=bfloat16, all-true mask", 1500, WHISPER_K1),
            ("internvl2 decode, G=8: B=8 Hq=64 n_kv=8 hd=128 S=200 "
             "kv=bfloat16", 200, INTERNVL2_K1)):
        def make(i, S=S, shape=shape):
            return k1_inputs(dev, 8, S, seed=i, **shape), {}
        q, k, v, mask, ks, vs, _ = make(0)[0]
        nb = nbytes(q, k, v, mask) + q.numel() * 4
        b_ms, b_by = bound(nb, 4 * 8 * shape["Hq"] * S * shape["hd"],
                           torch.bfloat16)
        var = variants_of(make, nb)
        lib = {"sdpa(enable_gqa)": time_ms(F.scaled_dot_product_attention,
                                           sdpa_args(var), 400)}
        rows.append(("flash_decode", label, time_ms(flash_decode, var, 400),
                     time_ms(flash_decode_ref, var, 50), b_ms, b_by, lib,
                     host_ms(flash_decode, var)))
    for R in (8, 384):
        (x, wg, wu, wd), _ = k3_inputs(dev, R, **INTERNVL2_FFN)
        D, F_ = wg.shape
        nb = nbytes(x, wg, wu, wd) + R * D * 4
        b_ms, b_by = bound(nb, 2 * R * D * F_ * 3, torch.bfloat16)
        del x, wg, wu, wd
        var = variants_of(lambda i, R=R: k3_inputs(dev, R, seed=i,
                                                   **INTERNVL2_FFN), nb)

        def lib_ffn(x, wg, wu, wd, act="silu"):
            return torch.matmul(F.silu(torch.matmul(x, wg))
                                * torch.matmul(x, wu), wd)
        lib = {"3x torch.matmul + silu (bf16)": time_ms(lib_ffn, var, 40)}
        rows.append(("fused_ffn", f"internvl2 FFN: rows={R} D=8192 F=28672 "
                     f"bf16", time_ms(fused_ffn, var, 40),
                     time_ms(fused_ffn_ref, var, 10), b_ms, b_by, lib,
                     host_ms(fused_ffn, var, 20)))
        del var
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# training: phase 2's K3 gradient, phase 3's loss and gradients on the CPU
# against CUDA, run (s) and phase 5's K3 at the training shape
# ---------------------------------------------------------------------------

# the train driver's defaults: batch 8 x seq 256 = 2,048 rows into K3 at
# qwen2-0.5b's D=896, F=4,864
TRAIN_ROWS, TRAIN_D, TRAIN_F = 8 * 256, 896, 4864
K3_GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
# K3 at one rank of phase 4e's (z6): 2 x 128 rows, recurrentgemma's D and
# half of its F (rows, D, F)
Z6_K3 = (256, 4096, 6144)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL, TRAIN_GRAD_FLOOR = 1e-3, 1e-5
# run (s): (name, arch, batch, seq, steps, the checkpointed step)
TRAIN_RUN = ("s_qwen2_train_12L_b8_s256", "qwen2-0.5b", 8, 256, 20, 10)
# (s) at 12 of qwen2-0.5b's 24 layers since phase 4c joined
TRAIN_RUN_LAYERS = 12
# the resumed job repeats the uninterrupted one: the same seeded data and
# deterministic kernels (the embedding's backward sorts its indices), so
# its losses are held to rounding, not to a training tolerance
RESUME_RTOL = 1e-6
# the loss of one batch the run never trains on, before and after its 20
# steps, must fall by at least this many nats: a run whose updates do
# nothing leaves it exactly where it was
HELD_OUT_FALL = 1e-2


def phase_compare_train(dev, errs):
    """K3 with a gradient (``FusedFFN``: the kernel's forward, the plain
    f32 products of ``fused_ffn_backward``) at the training shape (2,048
    rows, D=896, F=4,864) and at 17 rows of D=200, F=700 (no tile
    multiple), bf16 and f32, silu and gelu, against autograd of
    ``fused_ffn_ref`` on the same CUDA tensors and output gradient. dx and
    the three weight gradients within 1e-4 of their largest magnitude in
    f32, 8e-3 in bf16 (each side rounds its f32 gradient to bf16 once, at
    most one bf16 ulp apart); the forward within phase 2's 1e-4 and one K3
    launch a forward. Also at phase 4c's and phase 4e's rank shapes: (z6)'s
    gelu, f32, 256 rows of D=4,096 on half of F (6,144 of 12,288)."""
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    # the training shape, no tile multiple, and one rank's shapes in
    # phase 4c ((w): 512 rows of all of F; (x): 1,024 rows of half of F),
    # in both dtypes and modes; and phase 4e's (z6) rank shape: gelu, f32,
    # 2 x 128 rows on recurrentgemma's D and half of its F
    cases = [(R, D, F, dtype, act)
             for R, D, F in ((TRAIN_ROWS, TRAIN_D, TRAIN_F), (17, 200, 700),
                             (512, TRAIN_D, TRAIN_F),
                             (1024, TRAIN_D, TRAIN_F // 2))
             for dtype in (torch.bfloat16, torch.float32)
             for act in ("silu", "gelu")]
    cases.append(Z6_K3 + (torch.float32, "gelu"))
    for R, D, F, dtype, act in cases:
        args, _ = k3_inputs(dev, R, seed=R + 1, D=D, F=F,
                            dtype=dtype)
        g = torch.Generator(device=dev).manual_seed(R + 2)
        dout = torch.randn(R, D, device=dev, generator=g)
        a1 = [a.clone().requires_grad_(True) for a in args]
        n0 = fused_ffn.launches
        out = fused_ffn(*a1, act=act)
        launched = fused_ffn.launches - n0
        got = torch.autograd.grad(out, a1, dout)
        a2 = [a.clone().requires_grad_(True) for a in args]
        ref = fused_ffn_ref(*a2, act=act)
        want = torch.autograd.grad(ref, a2, dout)
        e_fwd = max_err(out.detach(), ref.detach())
        tol_fwd = 1e-4 * max(1, max_abs(ref.detach()))
        ratios = [max_err(a, b) / (K3_GRAD_RTOL[dtype] * max_abs(b))
                  for a, b in zip(got, want)]
        errs["fused_ffn"] = max(errs["fused_ffn"], e_fwd)
        log(f"  K3 autograd rows={R} D={D} F={F} "
            f"{str(dtype)[6:]} {act}: forward max|d|={e_fwd:.3g} "
            f"(tol {tol_fwd:.3g}), launches {launched}; gradients "
            f"max|d|/tol dx {ratios[0]:.3g}, dW_gate "
            f"{ratios[1]:.3g}, dW_up {ratios[2]:.3g}, dW_down "
            f"{ratios[3]:.3g} (tol {K3_GRAD_RTOL[dtype]:g} of max)")
        require(launched == 1, "K3's autograd forward did not "
                "launch the kernel once")
        require(e_fwd <= tol_fwd, f"K3 autograd forward disagrees "
                f"at rows={R} {dtype} {act}")
        require(all(np.isfinite(r) and r <= 1 for r in ratios),
                f"K3 gradients disagree at rows={R} {dtype} {act}")


def train_parity(cfg, B, S, devs=("cuda", "cpu")):
    """The loss and every gradient leaf of ``ModelAPI.loss`` on one
    seeded batch (``SyntheticLMData``), CPU (plain versions) against CUDA
    (kernels), on the same seeded f32 weights: the loss within 1e-5
    relative, each leaf within 1e-3 of its largest magnitude plus 1e-5 of
    the largest gradient (the key biases' true gradient is 0: rounding
    noise on both sides). Returns the CUDA side's K3 launches."""
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.interop import to_device
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import batch_to_torch
    from repro_torch.models.registry import build_model
    from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten
    src = to_device(build_model(cfg, device=devs[0]).init(0), "cpu")
    host = SyntheticLMData(cfg, B, S, seed=0).batch_at(0)
    paths = [p for p, _ in tree_paths(src)]
    res = {}
    for d in devs:
        api = build_model(cfg, device=d)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(to_device(src, api.device))]
        reset_launch_counts()
        t0 = time.monotonic()
        loss = api.loss(tree_unflatten(src, leaves),
                        batch_to_torch(host, api.device))
        grads = torch.autograd.grad(loss, leaves)
        res[d] = (float(loss.detach()), [g.float().cpu() for g in grads],
                  launch_counts(), time.monotonic() - t0)
    (l_gpu, g_gpu, counts, t_gpu), (l_cpu, g_cpu, _, t_cpu) = \
        res[devs[0]], res[devs[1]]
    l_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    top = max(float(g.abs().max()) for g in g_cpu)
    worst, where = 0.0, ""
    for p, a, b in zip(paths, g_gpu, g_cpu):
        require(bool(torch.isfinite(a).all()), f"{cfg.name}: gradient {p} "
                "not finite on cuda")
        r = float((a - b).abs().max()) / (
            TRAIN_GRAD_RTOL * float(b.abs().max()) + TRAIN_GRAD_FLOOR * top)
        if r > worst:
            worst, where = r, p
    log(f"  {cfg.name} training, full width, {cfg.n_layers} layers, f32, "
        f"batch {B} x {S}: loss cpu {l_cpu:.7f} cuda {l_gpu:.7f}, "
        f"|d|/loss {l_rel:.3g} (tol {TRAIN_LOSS_RTOL:g}); {len(paths)} "
        f"gradient leaves, worst max|d|/tol {worst:.3g} at {where} (tol "
        f"{TRAIN_GRAD_RTOL:g} of the leaf's max + {TRAIN_GRAD_FLOOR:g} of "
        f"the largest, {top:.3g}); cuda launches {counts}; loss + gradient "
        f"{t_gpu:.2f} s cuda, {t_cpu:.2f} s cpu")
    require(l_rel <= TRAIN_LOSS_RTOL, f"{cfg.name}: training loss differs "
            "between cpu and cuda")
    require(worst <= 1, f"{cfg.name}: gradient {where} differs between cpu "
            "and cuda")
    return counts


def phase_train_parity():
    """qwen2-0.5b (its FFN through K3: forward plus the remat recompute, 2
    launches a layer) and mamba2-1.3b (the SSD over two chunks of 256, no
    port kernel) at full width, 2 layers, f32."""
    from repro_torch.configs.registry import get_config
    t0 = time.monotonic()
    cfg = get_config("qwen2-0.5b").replace(n_layers=2, dtype="float32")
    counts = train_parity(cfg, 2, 128)
    require(counts["fused_ffn"] == 2 * cfg.n_layers
            and counts["gemv_int8"] == counts["flash_decode"] == 0,
            f"qwen2 training launched {counts}: want K3 twice a layer")
    cfg = get_config("mamba2-1.3b").replace(n_layers=2, dtype="float32")
    counts = train_parity(cfg, 2, 512)
    require(not any(counts.values()), f"mamba2 training launched {counts}")
    log(f"  training parity took {time.monotonic() - t0:.1f}s")


def phase_train_run(totals, runs, card):
    """Run (s): qwen2-0.5b at full width, 12 of its 24 layers (bf16,
    seeded random weights) through ``repro_torch.launch.train.train`` on
    cuda, batch 8 x seq 256, 20 steps, one loss a step (``log_every=1``).
    K3 launches 24 times a step (12 layers, forward and the remat
    recompute) and no other kernel; every loss is finite, the mean of
    the last 5 is below the first, and the loss of a held-out batch (the
    pipeline's step 20, which the run does not train on) falls by
    ``HELD_OUT_FALL`` from the initial weights to the trained ones. Then
    10 steps with a checkpoint at step 10: restored into a fresh model
    and optimizer it equals the returned state bit for bit (params, mu,
    nu, step); the job resumed from it to step 20 gives the uninterrupted
    run's losses within ``RESUME_RTOL`` (relative)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import batch_to_torch, train
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.static_runtime import StaticRuntime
    from repro_torch.tree import tree_leaves
    name, arch, B, S, steps, half = TRAIN_RUN
    cfg = get_config(arch).replace(n_layers=TRAIN_RUN_LAYERS)
    api = build_model(cfg)
    held_out = batch_to_torch(
        SyntheticLMData(cfg, B, S, seed=0).batch_at(steps), api.device)

    def held_out_loss(params):
        with torch.no_grad():
            return float(api.loss(params, held_out))
    # train()'s initial weights: the same seed (0)
    init = api.init(0)
    before = held_out_loss(init)
    del init
    rt = StaticRuntime()
    starts = []
    rt.set_interceptor(lambda _: starts.append(time.monotonic()))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.monotonic()
    params, opt, full = train(cfg, steps, B, S, reduced=False,
                              log_every=1, runtime=rt)
    torch.cuda.synchronize()
    total_s = time.monotonic() - t0
    counts = launch_counts()
    runs[name] = counts
    for k, n in counts.items():
        totals[k] += n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # one loss read a step (a host sync): dispatch to dispatch is a step
    gaps = np.diff(np.asarray(starts)) * 1e3
    losses = [v for _, v in full]
    log(f"  run {name}: {arch} x {cfg.n_layers} layers, bf16, batch {B} x "
        f"seq {S}, {steps} steps in {total_s:.1f}s (init included); "
        f"{np.median(gaps[1:]):.1f} ms a step (median of steps 2-"
        f"{steps - 1}, host clock, one sync a step; step 1 {gaps[0]:.1f} "
        f"ms), peak "
        f"memory {peak:.2f} GiB; launches {counts}; calls "
        f"{rt.stats()['train']['calls']}; {card}")
    log(f"    losses {[round(v, 4) for v in losses]}")
    require(len(losses) == steps and all(np.isfinite(losses)),
            f"{name}: a loss is not finite")
    require(np.mean(losses[-5:]) < losses[0], f"{name}: the loss did not "
            f"fall ({losses[0]:.4f} -> mean of the last 5 "
            f"{np.mean(losses[-5:]):.4f})")
    require(counts == {"flash_decode": 0, "flash_decode_partial": 0,
                       "fused_ffn": 2 * cfg.n_layers * steps,
                       "gemv_int8": 0},
            f"{name}: launches {counts}, want K3 {2 * cfg.n_layers} a step")
    require(rt.stats()["train"]["calls"] == steps, f"{name}: step calls")
    after = held_out_loss(params)
    log(f"    held-out batch (step {steps}'s, never trained on): loss "
        f"{before:.6f} at the initial weights -> {after:.6f} after "
        f"{steps} steps, fall {before - after:.6f} (need >= "
        f"{HELD_OUT_FALL:g})")
    require(before - after >= HELD_OUT_FALL, f"{name}: the held-out loss "
            f"did not fall ({before:.6f} -> {after:.6f})")
    trace_train_step(api, params, opt, B, S, steps)
    del params, opt
    torch.cuda.empty_cache()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.monotonic()
        p10, o10, first = train(cfg, half, B, S, reduced=False,
                                ckpt_dir=ckpt, ckpt_every=half, log_every=1)
        half_s = time.monotonic() - t0
        fresh = api.init(1)
        t0 = time.monotonic()
        step, state = Checkpointer(ckpt).restore(
            {"params": fresh, "opt": adamw_init(fresh)})
        restore_s = time.monotonic() - t0
        pairs = list(zip(tree_leaves({"params": p10, "opt": o10}),
                         tree_leaves(state)))
        same = step == half and all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in pairs)
        del p10, o10, fresh, state, pairs
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        _, opt, resumed = train(cfg, steps, B, S, reduced=False,
                                ckpt_dir=ckpt, ckpt_every=10 * steps,
                                log_every=1)
        resume_s = time.monotonic() - t0
        end_step = int(opt.step)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    head = max(abs(v - w) / abs(w) for (_, v), w in zip(first, losses))
    tail = max(abs(v - w) / abs(w)
               for (_, v), w in zip(resumed, losses[half:]))
    log(f"    checkpointed run: {half} steps + save in {half_s:.1f}s, "
        f"restore into a fresh model and optimizer {restore_s:.1f}s, "
        f"bit-equal to the saved state: {same}; resumed to step {end_step} "
        f"in {resume_s:.1f}s; largest |d|/loss against the uninterrupted "
        f"run: steps 1-{half} {head:.3g}, resumed steps {half + 1}-{steps} "
        f"{tail:.3g} (tol {RESUME_RTOL:g}; bit-equal: "
        f"{[v for _, v in first + resumed] == losses})")
    require(same, f"{name}: the restored state differs from the saved one")
    require([s for s, _ in resumed] == list(range(half + 1, steps + 1))
            and end_step == steps, f"{name}: did not resume at {half}")
    require(head <= RESUME_RTOL and tail <= RESUME_RTOL,
            f"{name}: resumed losses differ from the uninterrupted run's")
    torch.cuda.empty_cache()


def trace_train_step(api, params, opt, B, S, steps):
    """Where a training step's time goes: three steps split on the host
    clock (a synchronise after each part) into the loss forward, the
    backward and the AdamW update; then one step under the profiler:
    device busy time, kernels, the ops with the most device time and K3's
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.launch.train import batch_to_torch
    from repro_torch.optim.adamw import adamw_update, cosine_lr
    from repro_torch.tree import tree_leaves, tree_unflatten
    data = SyntheticLMData(api.config, B, S, seed=0)

    def step(i, parts):
        batch = batch_to_torch(data.batch_at(steps + i), api.device)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        value = api.loss(tree_unflatten(params, leaves), batch)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        grads = torch.autograd.grad(value, leaves)
        torch.cuda.synchronize()
        t2 = time.monotonic()
        lr = cosine_lr(opt.step, 3e-4, warmup=20, total=100)
        adamw_update(params, tree_unflatten(params, list(grads)), opt,
                     lr=lr)
        torch.cuda.synchronize()
        t3 = time.monotonic()
        parts.append((t1 - t0, t2 - t1, t3 - t2))

    parts = []
    for i in range(3):
        step(i, parts)
    f, b, u = (np.median([p[j] for p in parts]) * 1e3 for j in range(3))
    log(f"    one step split (median of 3, host clock, synchronised): "
        f"loss forward {f:.1f} ms, backward (remat recompute included) "
        f"{b:.1f} ms, AdamW update {u:.1f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(3, [])
        wall = time.monotonic() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy <= 0:
        log("    trace: profiler reported no device time (not measured)")
        return
    k3 = sum(e.self_device_time_total for e in kern
             if "gate_up_kernel" in e.key or "down_kernel" in e.key) / 1e3
    log(f"    trace of one step: wall {wall * 1e3:.1f} ms traced, device "
        f"busy {busy:.1f} ms in {sum(e.count for e in kern)} kernels, "
        f"idle share {1 - busy / (wall * 1e3):.3f}; K3 forward kernels "
        f"{k3:.2f} ms")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"      {e.key[:64]:64s} {e.self_device_time_total / 1e3:8.3f} "
            f"ms, {e.count} launches")


def train_timing_rows(dev, bound):
    """Phase 5 row of K3 at the training shape (2,048 rows, D=896, F=4,864,
    bf16) against its bound and three matmuls and silu; the plain-product
    backward (``fused_ffn_backward``, f32) timed for the record."""
    import torch.nn.functional as F
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import (fused_ffn_backward,
                                                   fused_ffn_ref)
    R, D, Fd = TRAIN_ROWS, TRAIN_D, TRAIN_F
    (x, wg, wu, wd), _ = k3_inputs(dev, R, D=D, F=Fd)
    nb = nbytes(x, wg, wu, wd) + R * D * 4
    b_ms, b_by = bound(nb, 2 * R * D * Fd * 3, torch.bfloat16)
    var = variants_of(lambda i: k3_inputs(dev, R, seed=i, D=D, F=Fd), nb)

    def lib_ffn(x, wg, wu, wd, act="silu"):
        return torch.matmul(F.silu(torch.matmul(x, wg))
                            * torch.matmul(x, wu), wd)
    lib = {"3x torch.matmul + silu (bf16)": time_ms(lib_ffn, var, 50)}
    row = ("fused_ffn", f"training: rows={R} D={D} F={Fd} bf16",
           time_ms(fused_ffn, var, 50), time_ms(fused_ffn_ref, var, 10),
           b_ms, b_by, lib, host_ms(fused_ffn, var))
    dout = torch.randn(R, D, device=dev)
    bwd = [((*a, dout), kw) for a, kw in var[:4]]
    bwd_ms = time_ms(fused_ffn_backward, bwd, 10)
    bwd_bound, bwd_by = bound(nb + nbytes(dout) + nbytes(x, wg, wu, wd),
                              8 * 2 * R * D * Fd, torch.float32)
    log(f"  K3 backward at the training shape (plain f32 products: gate "
        f"and up recomputed, 8 products of 2 x {R} x {D} x {Fd}): "
        f"{bwd_ms * 1e3:.2f} us, bound {bwd_bound * 1e3:.2f} us "
        f"({bwd_by}, f32 CUDA-core peak)")
    return [row]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


# ---------------------------------------------------------------------------
# phase 4b: serving on a mesh of two ranks sharing the card (gloo)
# ---------------------------------------------------------------------------

# llama3.2-3b (the paper's deployment) at full width, 8 of its 28 layers
# in runs (t) and (v), 2 in run (u) (MESH_U_LAYERS):
# at (1, 2) each rank holds 12 of 24 query heads over 4 of 8 KV heads (G=3,
# hd 128), half of F=8192 and half of the vocabulary rows
MESH_ARCH, MESH_LAYERS = "llama3.2-3b", 8
MESH_PROMPT, MESH_STEPS, MESH_B = 64, 16, 2
# run (u): run (a)'s plan (8 slots, prompt 128, 12 requests every 4 steps,
# 64 new tokens, blocks of 8, buckets of 64, chunks of 32), at 2 of the 28
# layers (4 until phase 4e joined the script): its time is the gloo
# collectives between two time-sliced ranks (a few ms each, six a layer a
# token step), which grows with the depth
MESH_U = dict(block_size=8, kv_bucket_chunk=64, prefill_chunk=32,
              max_new_cap=72)
MESH_U_LAYERS = 2


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _mesh_f32(cfg):
    return cfg.replace(n_layers=MESH_LAYERS, weight_int8=False,
                       kv_dtype="float32", dtype="float32")


def _mesh_run_t(mesh, full, cfg):
    """Run (t): prefill and MESH_STEPS greedy decode steps under
    sub_operator on (1, 2); rank 0 also runs the same weights unsharded.
    Returns the rank's launch counts, its check and the logits error."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param_specs import shard_params
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import ShardingCtx, sub_operator
    dev = mesh.device
    ctx = ShardingCtx(mesh, sub_operator())
    api = build_model(cfg, dev, ctx)
    params = shard_params(full, ctx)
    g = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (MESH_B, MESH_PROMPT),
                         device=dev, generator=g)

    def drive(api, params, gather):
        cache, lg = api.prefill(params, toks)
        outs, tok = [gather(lg[:, -1])], api.greedy(lg[:, -1])
        seq = [tok]
        for _ in range(MESH_STEPS):
            cache, lg = api.decode(params, cache, tok)
            outs.append(gather(lg[:, -1]))
            tok = api.greedy(lg[:, -1])
            seq.append(tok)
        return torch.stack(outs), torch.stack(seq)
    _sync(dev)
    reset_launch_counts()
    got, got_tok = drive(api, params, api.full_logits)
    _sync(dev)
    counts = launch_counts()
    res = {"counts": counts}
    if mesh.rank == 0:
        api1 = build_model(cfg, dev)
        want, want_tok = drive(api1, full, lambda x: x)
        err = float((got - want).abs().max())
        res.update(tokens_equal=bool(torch.equal(got_tok, want_tok)),
                   err=err, scale=float(want.abs().max()))
    return res


def _mesh_run_u(mesh, cfg, executor, full, dev):
    """Run (u): the engine in continuous mode on run (a)'s plan, int8
    weights and KV, under ``executor`` on (1, 2)."""
    from repro_torch.core.execution import make_rules
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.param_specs import shard_params
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import ShardingCtx
    from repro_torch.runtime.serving import ServingEngine
    ctx = ShardingCtx(mesh, make_rules(executor, mesh)) if mesh else None
    params = shard_params(full, ctx) if ctx else full
    reqs = make_requests(cfg, 12, 128, 64, seed=0, arrival_every=4)
    eng = ServingEngine(build_model(cfg, dev), 8, 128, device=dev, ctx=ctx,
                        **MESH_U)
    _sync(dev)
    reset_launch_counts()
    t0 = time.monotonic()
    st = eng.run(params, reqs)
    _sync(dev)
    wall = time.monotonic() - t0
    steps = st["macro_steps"] * MESH_U["block_size"]
    out = {"counts": launch_counts(), "streams": [r.generated for r in reqs],
           "completed": st["completed"], "host_syncs": st["host_syncs"],
           "tpot_mean_ms": st["tpot_mean_ms"], "wall_s": wall,
           "token_steps": steps}
    if ctx:
        m = st["mesh"]
        out.update(bytes_per_token_step=m["bytes_total"] / max(steps, 1),
                   bytes_per_site=m["bytes_per_site"],
                   control_calls=m["control_calls"])
    return out


# the repo's int8 rule (runs (u) and 4f): where int8 weights, int8 KV or a
# quantized cold tier lie on a run's path, a last-bit difference of a
# reduction moves an int8 rounding and then a token. On the card RMSNorm's
# mean and the unembedding's product depend on the batch's shape (a data
# row's 4 rows against the unsharded engine's 8; measured on the H100),
# K4 does not; on (1, 2) the sharded sums differ too. A request whose
# stream differs from the unsharded engine's is counted, and replayed
# (every one): its prompt through the chunk program, then the UNSHARDED
# stream teacher-forced through the run's programs on the mesh (slot 0
# of its data row's slots live) and unsharded over as many slots as a
# data row holds (the same batch shape); every step's logits within
# INT8_RULE_RTOL of max|logit|, the steps over 1e-4 counted. Where a data
# row holds fewer than the engine's 8 slots, the replay unsharded over 8
# is printed beside it: the batch shape's own share. Everything else is
# held exactly.
INT8_RULE_RTOL = 2e-2


def _replay(cfg, params, ctx, backend, prompt, stream, dev,
                 slots=8):
    """The int8 rule's replay of one request through ``backend``'s chunk
    and slotted decode programs on ``ctx`` (``NULL_CTX``: unsharded) over
    a fresh cache of ``slots`` slots and extent 200 (the engines of (u)
    and 4f: prompt width 128 and 72 new tokens at most): the prompt in chunks
    of 32 at slot 0, then ``stream`` teacher-forced with slot 0 live and
    the others idle. Returns the (steps, V) whole-vocabulary logits of
    slot 0: the last chunk's, then each decode step's."""
    from repro_torch.core.wa import WADisaggregated
    from repro_torch.models.registry import build_model
    if backend == "wa":
        wa = WADisaggregated(cfg, dev, mesh=ctx.mesh if ctx.active
                             else None)
        cache = wa.init_cache(slots, 200)
        chunk, step = wa.prefill_chunk, wa.decode_step_slotted
        gather = build_model(cfg, dev, wa.w_ctx).full_logits
    else:
        api = build_model(cfg, dev, ctx)
        cache = api.init_caches(slots, 200)
        chunk, step, gather = (api.prefill_chunk, api.decode_slotted,
                               api.full_logits)
    B = cache.k.shape[1]
    out = []
    for start in range(0, len(prompt), 32):
        valid = min(32, len(prompt) - start)
        row = np.zeros((1, 32), np.int64)
        row[0, :valid] = prompt[start:start + valid]
        cache, lg = chunk(params, cache, torch.from_numpy(row).to(dev), 0,
                          start, valid)
    out.append(gather(lg[:, -1])[0])
    act = torch.zeros(B, dtype=torch.bool, device=dev)
    act[0] = True
    for i, t in enumerate(stream[:-1]):
        tok = torch.zeros(B, dtype=torch.int32, device=dev)
        pos = torch.zeros(B, dtype=torch.int32, device=dev)
        tok[0], pos[0] = int(t), len(prompt) + i
        cache, lg = step(params, cache, tok, pos, act)
        out.append(gather(lg[:, 0])[0])
    return torch.stack(out).float()


def _flip_rule(mesh, cfg, params, full, ctx, backend, prompts, streams,
               unsharded, dev):
    """The int8 rule on every rank of ``mesh`` (the launch's): rank 0
    finds the requests whose stream differs from ``unsharded`` (its
    streams) and broadcasts every one of them with its unsharded stream;
    every rank replays them on ``ctx``, rank 0 also
    unsharded over as many slots as a data row holds. Returns (rank 0)
    [{"rid", "rel", "rel8"}]: per step max |dlogit| / max |logit|, and
    against the unsharded replay over 8 slots where a row holds fewer
    (else None)."""
    from repro_torch.core.collectives import control_broadcast
    from repro_torch.models.sharding import NULL_CTX
    flips = torch.full((len(prompts), 1 + 128), -1, dtype=torch.int64)
    if mesh.rank == 0:
        bad = [i for i, (a, b) in enumerate(zip(streams, unsharded))
               if a != b]
        for n, i in enumerate(bad):
            flips[n, 0] = i
            flips[n, 1:1 + len(unsharded[i])] = torch.tensor(unsharded[i])
    flips = control_broadcast(flips, mesh, 0)
    out = []
    for f in flips:
        if f[0] < 0:
            continue
        rid = int(f[0])
        stream = [int(t) for t in f[1:] if t >= 0]
        got = _replay(cfg, params, ctx, backend, prompts[rid], stream,
                           dev)
        if mesh.rank != 0:
            continue

        def rel(want):
            return ((got - want).abs().amax(dim=-1)
                    / want.abs().amax(dim=-1)).tolist()
        local = 8 // ctx.n(ctx.batch_axes)
        out.append({"rid": rid, "rel": rel(_replay(
            cfg, full, NULL_CTX, backend, prompts[rid], stream, dev, local)),
            "rel8": None if local == 8 else rel(_replay(
                cfg, full, NULL_CTX, backend, prompts[rid], stream, dev))})
    return out


def _hold_streams(key, by_rank, unsharded, replays):
    """Every rank's streams equal; those that differ from the unsharded
    engine's counted and held to the int8 rule by their replays."""
    got = by_rank[0]
    require(all(s == got for s in by_rank), f"({key}): the ranks' streams "
            "differ")
    flipped = [i for i, (a, b) in enumerate(zip(got, unsharded)) if a != b]
    log(f"    streams equal to the unsharded engine's: "
        f"{len(got) - len(flipped)} of {len(got)}; differing {flipped}")
    require([x["rid"] for x in replays] == flipped,
            f"({key}): a differing request was not replayed")
    for x in replays:
        over = sum(v > 1e-4 for v in x["rel"])
        log(f"    replay of request {x['rid']} (int8 rule): max "
            f"|dlogit|/max|logit| {max(x['rel']):.3e} over "
            f"{len(x['rel'])} steps, {over} steps above 1e-4"
            + ("" if x["rel8"] is None else
               f"; against one device over 8 slots "
               f"{max(x['rel8']):.3e}, "
               f"{sum(v > 1e-4 for v in x['rel8'])} steps above 1e-4"))
        require(max(x["rel"]) <= INT8_RULE_RTOL, f"({key}) request "
                f"{x['rid']}: logits beyond the int8 rule's "
                f"{INT8_RULE_RTOL}")


def _mesh_run_v(mesh2, full, cfg):
    """Run (v): WA device_put with W on rank 0 and A on rank 1 of a (2, 1)
    mesh: staggered slotted decode (slot 0 at MESH_PROMPT, slot 1 admitted
    at 40) for 4 steps; rank 0 also runs the colocated steps. Returns the
    rank's role, launch counts and (W) the logits error."""
    from repro_torch.core.wa import WADisaggregated, WAPlan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kv.cache import write_slot_kv
    from repro_torch.models.registry import build_model
    dev = mesh2.device
    api = build_model(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (2, MESH_PROMPT), device=dev,
                         generator=g)
    caches, lg = api.prefill(full, toks)
    c1, l1 = api.prefill(full, toks[1:, :40])
    caches = write_slot_kv(caches, c1, 1)
    cur = torch.stack([torch.argmax(lg[0, -1]),
                       torch.argmax(l1[0, -1])]).to(torch.int32)
    pos0 = torch.tensor([MESH_PROMPT, 40], dtype=torch.int32, device=dev)
    act = torch.ones(2, dtype=torch.bool, device=dev)
    wa = WADisaggregated(cfg, dev, mesh=mesh2, plan=WAPlan(True, 1, 1, "v"),
                         routing="device_put")
    ref_cache = dataclasses.replace(
        caches, k=caches.k.clone(), v=caches.v.clone(),
        length=caches.length.clone()) if wa.role == "w" else None
    _sync(dev)
    reset_launch_counts()
    tok, pos, got = cur, pos0, []
    for _ in range(4):
        if wa.role == "w":
            _, lg = wa.decode_step_slotted(full, None, tok, pos, act)
            got.append(lg[:, 0])
            tok = torch.argmax(lg[:, 0], -1).to(torch.int32)
        else:
            caches, _ = wa.decode_step_slotted(None, caches, tok, pos, act)
        pos = pos + 1
    _sync(dev)
    res = {"role": wa.role, "counts": launch_counts()}
    if wa.role == "w":
        tok, pos, want = cur, pos0, []
        for _ in range(4):
            ref_cache, lg = api.decode_slotted(full, ref_cache, tok, pos, act)
            want.append(lg[:, 0])
            tok = torch.argmax(lg[:, 0], -1).to(torch.int32)
            pos = pos + 1
        got, want = torch.stack(got), torch.stack(want)
        res.update(err=float((got - want).abs().max()),
                   scale=float(want.abs().max()))
    return res


def mesh_timing_rows(dev, bound, sdpa_args):
    """Phase 5 rows of K1, K3 and K4 at the shapes one rank of phase 4b
    gives them (llama3.2-3b cut over a 2-wide model axis): K1 over 12 query
    heads on 4 KV heads of 128 at run (u)'s decode (B=8, bf16 q, int8 KV,
    S=200) and run (t)'s (B=2, f32, S=80); K3 on half of F (D=3072
    F=4096, f32) at (t)'s decode and prefill rows; K4 at (u)'s local
    projections (wq 3072x1536, wk/wv 3072x512, wo rows 1536x3072,
    gate/up 3072x4096, w_down rows 4096x3072) at decode rows (8) and one
    prefill chunk (32)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    from repro_torch.kernels.gemv.ops import gemv_int8_q
    from repro_torch.kernels.gemv.ref import gemv_int8_ref
    rows = []
    heads = dict(Hq=12, n_kv=4, hd=128)
    for B, S, pair, dt in ((8, 200, ("bfloat16", "int8"), torch.bfloat16),
                           (2, 80, ("float32", "float32"), torch.float32)):
        q, k, v, mask, ks, vs, lim = k1_inputs(dev, B, S, pair, **heads)
        nb = nbytes(q, k, v, mask, ks, vs) + q.numel() * 4
        b_ms, b_by = bound(nb, 4 * B * 12 * S * 128, dt)
        var = variants_of(lambda i: (k1_inputs(dev, B, S, pair, seed=i,
                                               **heads), {}), nb)
        lib = {"sdpa(enable_gqa)": time_ms(F.scaled_dot_product_attention,
                                           sdpa_args(var), 400)}
        rows.append(("flash_decode", f"mesh rank: B={B} Hq=12 n_kv=4 "
                     f"hd=128 S={S} {pair[0]}/{pair[1]}",
                     time_ms(flash_decode, var, 400),
                     time_ms(flash_decode_ref, var, 50), b_ms, b_by, lib,
                     host_ms(flash_decode, var)))
    for R in (2, 128):
        (x, wg, wu, wd), _ = k3_inputs(dev, R, D=3072, F=4096,
                                       dtype=torch.float32)
        nb = nbytes(x, wg, wu, wd) + R * 3072 * 4
        b_ms, b_by = bound(nb, 2 * R * 3072 * 4096 * 3, torch.float32)
        var = variants_of(lambda i: k3_inputs(dev, R, seed=i, D=3072,
                                              F=4096, dtype=torch.float32),
                          nb)

        def lib_ffn(x, wg, wu, wd, act="silu"):
            return torch.matmul(F.silu(torch.matmul(x, wg))
                                * torch.matmul(x, wu), wd)
        lib = {"3x torch.matmul + silu (f32)": time_ms(lib_ffn, var, 100)}
        rows.append(("fused_ffn", f"mesh rank: rows={R} D=3072 F=4096 f32",
                     time_ms(fused_ffn, var, 100),
                     time_ms(fused_ffn_ref, var, 20), b_ms, b_by, lib,
                     host_ms(fused_ffn, var)))
    for R in (8, 32):
        for K, N in ((3072, 1536), (3072, 512), (1536, 3072), (3072, 4096),
                     (4096, 3072)):
            (xq, xs, wq, ws), _ = k4_inputs(dev, R, K, N)
            nb = nbytes(xq, xs, wq, ws) + R * N * 4
            b_ms, b_by = bound(nb, 2 * R * K * N, torch.int8)
            var = variants_of(lambda i: k4_inputs(dev, R, K, N, seed=i), nb)
            dq = [((a[0].to(torch.bfloat16),
                    (a[2].float() * a[3]).to(torch.bfloat16)), {})
                  for a, _ in var]
            lib = {"bf16 torch.matmul on dequantized weights":
                   time_ms(torch.matmul, dq, 400)}
            rows.append(("gemv_int8", f"mesh rank: rows={R} K={K} N={N}",
                         time_ms(gemv_int8_q, var, 400),
                         time_ms(gemv_int8_ref, var, 50), b_ms, b_by, lib,
                         host_ms(gemv_int8_q, var)))
    return rows


def _mesh_collective_ms(mesh, n=100):
    """Host ms a call of the collectives (1, 2) runs take a token step on
    (8 rows of llama3.2-3b's residual: all-gather of a bf16 (8, 1536)
    half, reduce-scatter of an f32 (8, 3072) partial), on CUDA tensors
    (gloo straight through) and on CPU tensors (gloo alone), each call
    synchronised: what one collective costs the lock-step loop."""
    from repro_torch.core import collectives as C
    out = {}
    for dev in (mesh.device, torch.device("cpu")):
        half = torch.randn(8, 1536, device=dev).to(torch.bfloat16)
        part = torch.randn(8, 3072, device=dev)
        for name, fn in (("all_gather", lambda: C.all_gather(
                half, mesh, ("model",), 1)),
                ("reduce_scatter", lambda: C.reduce_scatter(
                    part, mesh, ("model",), 1))):
            fn()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
                _sync(dev)
            out[f"{name}_{dev.type}"] = (time.perf_counter() - t0) / n * 1e3
    return out


def mesh_rank(mesh, reduced=False):
    """One rank of phase 4b (runs (t), (u), (v)) on the shared card.
    ``reduced``: the reduced config, for a rehearsal on the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.execution import make_rules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.param_specs import shard_params
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import ShardingCtx
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    base = get_config(MESH_ARCH)
    if reduced:
        base = base.reduced()
    cfg_t = _mesh_f32(base)
    full = build_model(cfg_t, mesh.device).init(0)
    out = {"t": _mesh_run_t(mesh, full, cfg_t)}
    out["t_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    mesh2 = Mesh((2, 1), ("data", "model"), mesh.device)
    out["v"] = _mesh_run_v(mesh2, full, cfg_t)
    out["v_s"] = time.monotonic() - t0
    out["coll_ms"] = _mesh_collective_ms(mesh)
    del full
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    cfg_u = base.replace(n_layers=MESH_U_LAYERS)
    full = build_model(cfg_u, mesh.device).init(0)
    out["u"] = {ex: _mesh_run_u(mesh, cfg_u, ex, full, mesh.device)
                for ex in ("sub_operator", "operator_centric")}
    # the unsharded run once, on rank 0; the int8 rule over the streams
    # of sub_operator that differ from it
    un = None
    if mesh.rank == 0:
        un = out["u"]["unsharded"] = _mesh_run_u(None, cfg_u, None, full,
                                                 mesh.device)
    ctx = ShardingCtx(mesh, make_rules("sub_operator", mesh))
    out["u_replay"] = _flip_rule(
        mesh, cfg_u, shard_params(full, ctx), full, ctx, "colocated",
        [r.prompt for r in make_requests(cfg_u, 12, 128, 64, seed=0,
                                         arrival_every=4)],
        out["u"]["sub_operator"]["streams"], un["streams"] if un else None,
        mesh.device)
    out["u_s"] = time.monotonic() - t0
    out["rank"] = mesh.rank
    return out


def phase_mesh(totals, runs):
    """Runs (t)-(v) on two ranks sharing the card over gloo (the kernels
    are built already: the ranks load them). Every rank resets the launch
    counts before each run and reports them; a rank that never launched a
    kernel of its path fails the phase."""
    from repro_torch.launch.mesh import launch
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    res = launch(mesh_rank, (1, 2), ("data", "model"), device="cuda",
                 share_device=True, threads=4, timeout_s=600).join()
    log(f"  ranks joined after {time.monotonic() - t0:.1f}s")
    r0 = res[0]
    for r in res:
        log(f"  rank {r['rank']}: (t) {r['t_s']:.1f}s {r['t']['counts']}, "
            f"(v) {r['v_s']:.1f}s {r['v']['role']} {r['v']['counts']}, "
            f"(u) {r['u_s']:.1f}s")
        require(r["t"]["counts"]["flash_decode"] > 0
                and r["t"]["counts"]["fused_ffn"] > 0,
                f"(t) rank {r['rank']}: K1 or K3 never launched")
        need = "fused_ffn" if r["v"]["role"] == "w" else "flash_decode"
        require(r["v"]["counts"][need] > 0,
                f"(v) rank {r['rank']} ({r['v']['role']}): {need} never "
                "launched")
        for ex in ("sub_operator", "operator_centric"):
            u = r["u"][ex]
            require(u["counts"]["flash_decode"] > 0
                    and u["counts"]["gemv_int8"] > 0,
                    f"(u) {ex} rank {r['rank']}: K1 or K4 never launched")
            require(u["completed"] == 12, f"(u) {ex}: not all completed")
    log(f"  one collective, host ms a call (synchronised, 100 calls, "
        f"rank 0): {json.dumps(r0['coll_ms'])}")
    t = r0["t"]
    log(f"  (t) f32 sub_operator (1,2): tokens equal unsharded "
        f"{t['tokens_equal']}, max|dlogit| {t['err']:.3e} of max|logit| "
        f"{t['scale']:.3f}")
    require(t["tokens_equal"], "(t): tokens differ from the unsharded run")
    require(t["err"] <= 1e-4 * t["scale"], "(t): logits differ")
    v = r0["v"]
    require(v["role"] == "w", "(v): rank 0 is not the W rank")
    log(f"  (v) WA device_put W=rank 0, A=rank 1: max|dlogit| "
        f"{v['err']:.3e} of max|logit| {v['scale']:.3f}")
    require(v["err"] <= 1e-4 * v["scale"], "(v): logits differ from "
            "colocated")
    un = r0["u"]["unsharded"]
    flips = {}
    for ex in ("sub_operator", "operator_centric"):
        u = r0["u"][ex]
        flips[ex] = sum(a != b for a, b in zip(u["streams"],
                                               un["streams"]))
        log(f"  (u) {ex}: collective bytes per token step "
            f"{u['bytes_per_token_step']:.0f} (per rank; "
            f"{json.dumps(u['bytes_per_site'])}), control calls "
            f"{u['control_calls']}, host syncs {u['host_syncs']}, TPOT "
            f"mean {u['tpot_mean_ms']:.3f} ms, serve {u['wall_s']:.1f}s, "
            f"requests whose stream differs from unsharded "
            f"{flips[ex]} of 12")
    log(f"  (u) unsharded: host syncs {un['host_syncs']}, TPOT mean "
        f"{un['tpot_mean_ms']:.3f} ms, serve {un['wall_s']:.1f}s")
    require(r0["u"]["sub_operator"]["streams"]
            == r0["u"]["operator_centric"]["streams"],
            "(u): the two executors' streams differ")
    _hold_streams("u", [r["u"]["sub_operator"]["streams"] for r in res],
                  un["streams"], r0["u_replay"])
    for r in res:
        for name, c in (("t_mesh_f32_sub_operator", r["t"]["counts"]),
                        ("v_mesh_wa_device_put", r["v"]["counts"]),
                        ("u_mesh_int8_sub_operator",
                         r["u"]["sub_operator"]["counts"]),
                        ("u_mesh_int8_operator_centric",
                         r["u"]["operator_centric"]["counts"])):
            key = f"{name}_rank{r['rank']}"
            runs[key] = c
            for k, n in c.items():
                totals[k] += n


# ---------------------------------------------------------------------------
# phase 4c: training on a mesh of two ranks sharing the card (gloo)
# ---------------------------------------------------------------------------

# qwen2-0.5b at full width (D 896, 14/2 heads, F 4,864, V 151,936), 8 of
# its 24 layers, bf16, seeded weights; a global batch of 4 x 256 from the
# synthetic data of ``launch.train`` (steps 1-4 take its batches 0-3). At
# (2, 1) a rank trains 2 x 256 = 512 rows on the whole F; at (1, 2) all
# 1,024 rows on half of F (2,432)
TRAIN_MESH_ARCH, TRAIN_MESH_LAYERS = "qwen2-0.5b", 8
TRAIN_MESH_B, TRAIN_MESH_S, TRAIN_MESH_STEPS = 4, 256, 4
TRAIN_MESH_CKPT = 2
TRAIN_MESH_LOSS_RTOL, TRAIN_MESH_GNORM_RTOL = 1e-2, 5e-2


def _train_mesh_cfg(reduced):
    from repro_torch.configs.registry import get_config
    base = get_config(TRAIN_MESH_ARCH)
    return (base.reduced() if reduced else base).replace(
        n_layers=TRAIN_MESH_LAYERS)


def _train_mesh_batches(cfg, dev):
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.launch.train import batch_to_torch
    data = SyntheticLMData(cfg, TRAIN_MESH_B, TRAIN_MESH_S, seed=0)
    return [batch_to_torch(data.batch_at(i), dev)
            for i in range(TRAIN_MESH_STEPS)]


def _train_mesh_steps(bundle, cfg, params, opt, batches, first=1,
                      ckpt=None):
    """``make_step(mode="train")``'s steps ``first``.. over ``batches``
    on this rank: per step (loss, grad_norm), ms a step (synchronised),
    the launch counts, the collective calls and bytes a step by site and
    the peak memory. ``ckpt``: save the state after step
    ``TRAIN_MESH_CKPT`` there (rank 0 writes the whole tree)."""
    from repro_torch.core import collectives as C
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import save_state
    mesh, dev = bundle.ctx.mesh, bundle.ctx.mesh.device
    meter = C.meter(mesh)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    meter.reset()
    out, t_steps = [], 0.0
    for i, batch in enumerate(batches, start=first):
        t0 = time.monotonic()
        params, opt, info = bundle.fn(params, opt, batch)
        out.append((float(info["loss"]), float(info["grad_norm"])))
        t_steps += time.monotonic() - t0
        if ckpt is not None and i == TRAIN_MESH_CKPT:
            save_state(ckpt, i, params, opt, cfg, bundle.ctx)
    counts = launch_counts()
    n = len(batches)
    sites = {}
    for (k, site), b in meter.bytes.items():
        if site == "gather_params":         # the checkpoint's, not a step's
            continue
        c, b0 = sites.get(site, (0, 0.0))
        sites[site] = (c + meter.calls[(k, site)] / n, b0 + b / n)
    return {"steps": out, "ms_per_step": t_steps / n * 1e3,
            "counts": counts, "sites": sites,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else 0.0}


def train_mesh_rank(mesh, ckpt_dir, reduced=False):
    """One rank of phase 4c's runs (w) and (x) on the shared card, and on
    rank 0 the same steps unsharded. ``reduced``: the reduced config, for a
    rehearsal on the CPU."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.execution import make_step
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.param_specs import shard_params
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_mesh_cfg(reduced)
    dev = mesh.device
    full = build_model(cfg, dev).init(0)
    batches = _train_mesh_batches(cfg, dev)
    shape = ShapeConfig("t", TRAIN_MESH_S, TRAIN_MESH_B, "train")
    out = {"rank": mesh.rank}
    for name, grid in (("w", (2, 1)), ("x", (1, 2))):
        t0 = time.monotonic()
        m = mesh if grid == mesh.devices_shape else Mesh(
            grid, ("data", "model"), dev)
        bundle = make_step(cfg, shape, m, "sub_operator")
        params = shard_params(full, bundle.ctx)
        out[name] = _train_mesh_steps(
            bundle, cfg, params, adamw_init(params), batches,
            ckpt=Checkpointer(ckpt_dir) if name == "w" else None)
        out[name]["wall_s"] = time.monotonic() - t0
        del params, bundle
    if mesh.rank == 0:
        out["unsharded"] = _unsharded_steps(cfg, full, batches, dev)
    return out


def _unsharded_steps(cfg, params, batches, dev):
    """``make_step``'s training steps on one device in this process, from
    ``params`` (whole) over ``batches``, at the bundle's learning rate:
    per step (loss, grad_norm), ms a step (host clock to each step's
    loss on the host) and the peak memory."""
    from repro_torch.core.execution import train_update
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init, cosine_lr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    api = build_model(cfg, dev)
    opt, steps = adamw_init(params), []
    t0 = time.monotonic()
    for batch in batches:
        params, opt, info = train_update(
            params, opt, batch, loss=api.loss,
            lr_t=cosine_lr(opt.step, 3e-4, warmup=100, total=10_000))
        steps.append((float(info["loss"]), float(info["grad_norm"])))
    return {"steps": steps,
            "ms_per_step": (time.monotonic() - t0) / len(batches) * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else 0.0}


def train_resume_rank(mesh, ckpt_dir, reduced=False):
    """Run (y) on the re-meshed ranks: the step built on the new mesh,
    the latest checkpoint restored and cut to this rank, the steps after
    it on their batches."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.execution import make_step
    from repro_torch.launch.train import restore_state
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_mesh_cfg(reduced)
    dev = mesh.device
    bundle = make_step(cfg, ShapeConfig("t", TRAIN_MESH_S, TRAIN_MESH_B,
                                        "train"), mesh, "sub_operator")
    step, params, opt = restore_state(Checkpointer(ckpt_dir), cfg,
                                      bundle.ctx, dev)
    res = _train_mesh_steps(bundle, cfg, params, opt,
                            _train_mesh_batches(cfg, dev)[step:],
                            first=step + 1)
    res.update(restored=step, opt_step=int(opt.step))
    return res


def phase_train_mesh(totals, runs, device="cuda", reduced=False):
    """Runs (w), (x) and (y) (the module's constants above): (w) and (x)
    on two ranks sharing the card over gloo, each step's loss held to the
    unsharded step's within 1e-2 and its grad norm within 5e-2
    (relative), K3 launched on every rank; then data domain 1 fails, the
    elastic controller re-meshes to (1, 1), whose rank restores (w)'s
    step-2 checkpoint and runs steps 3-4 within 1e-2 of (w)'s."""
    import shutil
    import tempfile
    from repro_torch.launch.mesh import launch
    from repro_torch.runtime.elastic import ElasticController, remesh
    if device == "cuda":
        torch.cuda.empty_cache()
    ckpt_dir = tempfile.mkdtemp(prefix="train-mesh-")
    kw = dict(device=device, share_device=device == "cuda", threads=4,
              timeout_s=600)
    try:
        t0 = time.monotonic()
        res = launch(train_mesh_rank, (2, 1), ("data", "model"),
                     (ckpt_dir, reduced), **kw).join()
        log(f"  (w), (x): ranks joined after {time.monotonic() - t0:.1f}s")
        ec = ElasticController(n_data=2, n_model=1)
        ec.inject_failure(1, "injected after the step-2 checkpoint")
        t0 = time.monotonic()
        shape, step, resumed = remesh(ec, lambda shape: launch(
            train_resume_rank, shape, ("data", "model"),
            (ckpt_dir, reduced), **kw), ckpt_dir)
        log(f"  (y): re-mesh to {shape} from step {step} took "
            f"{time.monotonic() - t0:.1f}s; events {ec.events}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    un = res[0]["unsharded"]
    log(f"  unsharded (rank 0): losses "
        f"{[round(x, 5) for x, _ in un['steps']]}, grad norms "
        f"{[round(g, 4) for _, g in un['steps']]}, peak memory "
        f"{un['peak_gib']:.2f} GiB")
    for name, what in (("w", "(2,1) sub_operator+fsdp"),
                       ("x", "(1,2) sub_operator")):
        for r in res:
            run = r[name]
            log(f"  ({name}) {what} rank {r['rank']}: "
                f"{run['ms_per_step']:.1f} ms a step, "
                f"peak memory {run['peak_gib']:.2f} GiB, launches "
                f"{run['counts']}, wall {run['wall_s']:.1f}s")
            log(f"    collectives a step by site (calls, bytes): "
                + ", ".join(f"{s} {c:g} / {b:.0f}" for s, (c, b) in
                            sorted(run["sites"].items())))
            require(device != "cuda" or run["counts"]["fused_ffn"] > 0,
                    f"({name}) rank {r['rank']}: K3 never launched")
            key = f"{name}_train_mesh_rank{r['rank']}"
            runs[key] = run["counts"]
            for k, n in run["counts"].items():
                totals[k] += n
        got = res[0][name]["steps"]
        log(f"  ({name}) losses {[round(x, 5) for x, _ in got]}, grad "
            f"norms {[round(g, 4) for _, g in got]}")
        for i, ((gl, gn), (wl, wn)) in enumerate(zip(got, un["steps"]), 1):
            require(np.isfinite(gl) and abs(gl - wl) <= TRAIN_MESH_LOSS_RTOL
                    * abs(wl), f"({name}) step {i}: loss {gl} vs "
                    f"unsharded {wl}")
            require(abs(gn - wn) <= TRAIN_MESH_GNORM_RTOL * abs(wn),
                    f"({name}) step {i}: grad norm {gn} vs unsharded {wn}")
    y = resumed[0]
    log(f"  (y) rank 0 of {shape}: restored step {y['restored']} "
        f"(optimizer step {y['opt_step']}), losses "
        f"{[round(x, 5) for x, _ in y['steps']]}, {y['ms_per_step']:.1f} ms "
        f"a step, launches {y['counts']}")
    require(shape == (1, 1) and step == TRAIN_MESH_CKPT
            and y["opt_step"] == TRAIN_MESH_CKPT,
            "(y): not re-meshed to (1, 1) from the step-2 checkpoint")
    require(device != "cuda" or y["counts"]["fused_ffn"] > 0,
            "(y): K3 never launched")
    want = res[0]["w"]["steps"][TRAIN_MESH_CKPT:]
    require(len(y["steps"]) == len(want), "(y): not every step ran")
    for (gl, _), (wl, _) in zip(y["steps"], want):
        require(abs(gl - wl) <= TRAIN_MESH_LOSS_RTOL * abs(wl),
                f"(y): loss {gl} vs (w)'s {wl}")
    runs["y_train_remesh_1x1"] = y["counts"]
    for k, n in y["counts"].items():
        totals[k] += n


def train_mesh_timing_rows(dev, bound):
    """Phase 5 rows of K3 at the shapes one rank of phase 4c gives it
    (bf16, D=896): 512 rows at F=4,864 ((w): half the batch, all of F) and
    1,024 rows at F=2,432 ((x): the whole batch, half of F), against their
    bounds and three matmuls and silu."""
    import torch.nn.functional as F
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    rows = []
    for R, Fd in ((512, 4864), (1024, 2432)):
        (x, wg, wu, wd), _ = k3_inputs(dev, R, D=896, F=Fd)
        nb = nbytes(x, wg, wu, wd) + R * 896 * 4
        b_ms, b_by = bound(nb, 2 * R * 896 * Fd * 3, torch.bfloat16)
        var = variants_of(lambda i: k3_inputs(dev, R, seed=i, D=896, F=Fd),
                          nb)

        def lib_ffn(x, wg, wu, wd, act="silu"):
            return torch.matmul(F.silu(torch.matmul(x, wg))
                                * torch.matmul(x, wu), wd)
        lib = {"3x torch.matmul + silu (bf16)": time_ms(lib_ffn, var, 100)}
        rows.append(("fused_ffn", f"training mesh rank: rows={R} D=896 "
                     f"F={Fd} bf16", time_ms(fused_ffn, var, 100),
                     time_ms(fused_ffn_ref, var, 20), b_ms, b_by, lib,
                     host_ms(fused_ffn, var)))
    return rows


# ---------------------------------------------------------------------------
# phase 4d: pipeline-parallel decode over the pod axis, and the recurrent
# and enc-dec families served on a mesh, two ranks sharing the card (gloo)
# ---------------------------------------------------------------------------

# (z1): llama3.2-3b (the paper's deployment: int8 weights and KV) in bf16
# at full width, 8 of its 28 layers as two pipeline stages of 4 on a
# (2, 1, 1) ("pod", "data", "model") mesh, B=8, 24 calls of the PP decode
# step (``make_step(pod_strategy="pp")``), held on each rank to the same
# stage loop run unsharded in one process (the hop done locally)
PP_ARCH, PP_LAYERS, PP_STAGES, PP_B, PP_CALLS, PP_SEQ = (
    "llama3.2-3b", 8, 2, 8, 24, 64)
# (z2)-(z4) on (1, 2) in f32, at full width, cut in depth: mamba2 4 of 48
# layers, recurrentgemma one superblock (r, r, attention: 3 of 38),
# whisper 2 + 2 of 24 + 24; prefill 2 x 64 (whisper with 1,500 frames),
# then 16 greedy steps against the unsharded model on rank 0; (z2) also
# through the engine on run (a)'s plan against the unsharded engine
FAM_MESH_RUNS = {
    "z2_mamba2": ("mamba2-1.3b", 4),
    "z3_recurrentgemma": ("recurrentgemma-9b", 3),
    "z4_whisper": ("whisper-medium", 2),
}
FAM_MESH_B, FAM_MESH_PROMPT, FAM_MESH_STEPS = 2, 64, 16
FAM_MESH_KERNELS = {"z2_mamba2": (),
                    "z3_recurrentgemma": ("flash_decode", "fused_ffn"),
                    "z4_whisper": ("flash_decode",)}


def _pp_cfg(reduced):
    from repro_torch.configs.registry import get_config
    base = get_config(PP_ARCH)
    if reduced:
        base = base.reduced()
    return base.replace(n_layers=PP_LAYERS, dtype="bfloat16",
                        kv_dtype="int8")


def pp_unsharded(cfg, full, toks, dev):
    """The PP decode step's stage loop in one process: per call each
    stage in turn (stage 0 embeds its token row, the others take their
    carried activation), its layers over its own int8 KV at its cursor,
    its logits; then each stage's activation moves one stage on. Returns
    (per call the list of every stage's f32 logits (B, V), the stages'
    caches)."""
    from repro_torch.core.pipeline import stage_params
    from repro_torch.kv.cache import init_kv_cache
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    staged = stage_params(full, PP_STAGES)
    dt = common.dtype_of(cfg)
    caches = [init_kv_cache(cfg.n_layers // PP_STAGES, PP_B,
                            cfg.n_kv_heads, PP_SEQ + 128, cfg.head_dim,
                            dtype=dt, quantized=True, device=dev)
              for _ in range(PP_STAGES)]
    carry = [torch.zeros(PP_B, 1, cfg.d_model, dtype=dt, device=dev)
             for _ in range(PP_STAGES)]
    act = torch.ones(PP_B, dtype=torch.bool, device=dev)
    out = []
    for t in range(toks.shape[0]):
        xs, lgs = [], []
        for s, kv in enumerate(caches):
            x = common.embed(full["embed"], toks[t, s][:, None]).to(dt) \
                if s == 0 else carry[s]
            pos = kv.length
            for i, lp in enumerate(staged["blocks"][s]):
                x = T.block_decode_slotted(lp, x, cfg, kv.layer(i),
                                           pos.expand(PP_B), act,
                                           kv_limit=(pos + 1).to(
                                               torch.int32))
            lgs.append(T.final_logits(full, x, cfg)[:, 0].float())
            kv.length = (pos + 1).to(torch.int32)
            xs.append(x)
        carry = [xs[(s - 1) % PP_STAGES] for s in range(PP_STAGES)]
        out.append(lgs)
    return out, caches


def pp_rank(mesh, reduced=False):
    """One rank of (z1): its stage of the PP decode step, PP_CALLS calls
    (each synchronised: the wall a call), the pod axis's bytes by site,
    its launches; then the unsharded stage loop on this rank, against
    which its stage's logits, tokens and stored int8 K/V are held."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core import collectives as C
    from repro_torch.core.execution import make_step
    from repro_torch.core.pipeline import stage_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param_specs import shard_params
    from repro_torch.models.registry import build_model
    dev = mesh.device
    t_start = time.monotonic()
    cfg = _pp_cfg(reduced)
    full = build_model(cfg, dev).init(0)
    s = mesh.coords["pod"]
    bundle = make_step(cfg, ShapeConfig("pp", PP_SEQ, PP_B, "decode"), mesh,
                       "sub_operator", pod_strategy="pp")
    params = shard_params(stage_params(full, PP_STAGES, s), bundle.ctx)
    caches = bundle.init_caches()
    g = torch.Generator().manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (PP_CALLS, PP_STAGES, PP_B),
                         generator=g).to(dev)
    meter = C.meter(mesh)
    meter.reset()
    _sync(dev)
    reset_launch_counts()
    got, walls = [], []
    for t in range(PP_CALLS):
        t0 = time.perf_counter()
        caches, lg = bundle.fn(params, caches, toks[t])
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        got.append(lg[:, 0].float())
    counts = launch_counts()
    pod = {site: b for (k, site), b in meter.bytes.items() if "pod" in k}
    other = {f"{k}|{site}": b for (k, site), b in meter.bytes.items()
             if "pod" not in k}
    # the hop alone: one exchange of this rank's x_carry, synchronised
    x = caches["x_carry"]
    buf = torch.empty_like(x)
    nxt = mesh.rank_at(pod=(s + 1) % PP_STAGES)
    for i in range(21):
        if i == 1:
            t0 = time.perf_counter()
        C.exchange([(x, nxt)], [(buf, nxt)], mesh, "pod", "hop_probe")
        _sync(dev)
    hop_ms = (time.perf_counter() - t0) / 20 * 1e3
    want, ref = pp_unsharded(cfg, full, toks, dev)
    got = torch.stack(got)
    mine = torch.stack([w[s] for w in want])
    scale = mine.abs().amax(dim=(1, 2)).clamp_min(1e-30)
    rel = ((got - mine).abs().amax(dim=(1, 2)) / scale).tolist()
    kv = caches["kv"]
    flips = int((kv.k != ref[s].k).sum() + (kv.v != ref[s].v).sum())
    _sync(dev)
    return {"rank": mesh.rank, "stage": s, "counts": counts,
            "pod_bytes": pod, "other_bytes": other, "wall_ms": walls,
            "hop_ms": hop_ms, "rel": rel,
            "tokens_equal": bool(torch.equal(got.argmax(-1),
                                             mine.argmax(-1))),
            "flips": flips, "length": int(kv.length),
            "itemsize": x.element_size(), "d_model": cfg.d_model,
            "took_s": time.monotonic() - t_start}


def _fam_cfg(arch, layers, reduced):
    from repro_torch.configs.registry import get_config
    base = get_config(arch)
    if reduced:
        base = base.reduced()
    over = dict(n_layers=layers, dtype="float32")
    if base.encoder is not None:
        over["encoder"] = dataclasses.replace(base.encoder, n_layers=layers)
    return base.replace(**over)


def _fam_drive(api, params, toks, extra, gather):
    """Prefill, then FAM_MESH_STEPS greedy steps: (logits (steps+1, B, V)
    whole, tokens (steps+1, B))."""
    cache, lg = api.prefill(params, toks, *extra)
    outs, tok = [gather(lg[:, -1])], api.greedy(lg[:, -1])
    seq = [tok]
    for _ in range(FAM_MESH_STEPS):
        cache, lg = api.decode(params, cache, tok)
        outs.append(gather(lg[:, -1]))
        tok = api.greedy(lg[:, -1])
        seq.append(tok)
    return torch.stack(outs).float(), torch.stack(seq)


def fam_mesh_rank(mesh, reduced=False):
    """One rank of (z2)-(z4) on (1, 2) under sub_operator: each run's
    sharded model against the unsharded one on rank 0 (per step max
    |dlogit| / max|logit|, tokens), launches and ms a step; (z2) also
    through the engine on run (a)'s plan (rank 0 serves it unsharded
    too)."""
    from repro_torch.core import collectives as C
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.param_specs import shard_params
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import ShardingCtx, sub_operator
    from repro_torch.runtime.serving import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    ctx = ShardingCtx(mesh, sub_operator())
    out = {"rank": mesh.rank}
    for key, (arch, layers) in FAM_MESH_RUNS.items():
        t_start = time.monotonic()
        cfg = _fam_cfg(arch, layers, reduced)
        full = build_model(cfg, dev).init(0)
        g = torch.Generator().manual_seed(12)
        toks = torch.randint(0, cfg.vocab_size,
                             (FAM_MESH_B, FAM_MESH_PROMPT),
                             generator=g).to(dev)
        extra = ()
        if cfg.encoder is not None:
            extra = (torch.randn(FAM_MESH_B, cfg.encoder.n_frames,
                                 cfg.d_model, generator=g).to(dev),)
        api = build_model(cfg, dev, ctx)
        params = shard_params(full, ctx)
        C.meter(mesh).reset()
        _sync(dev)
        reset_launch_counts()
        t0 = time.monotonic()
        got, got_tok = _fam_drive(api, params, toks, extra, api.full_logits)
        _sync(dev)
        res = {"counts": launch_counts(),
               "ms_per_step": (time.monotonic() - t0) * 1e3
               / (FAM_MESH_STEPS + 1),
               "bytes_per_site": C.meter(mesh).stats()["bytes_per_site"],
               "layers": layers}
        if mesh.rank == 0:
            api1 = build_model(cfg, dev)
            want, want_tok = _fam_drive(api1, full, toks, extra,
                                        lambda x: x)
            scale = want.abs().amax(dim=(1, 2)).clamp_min(1e-30)
            res.update(rel=((got - want).abs().amax(dim=(1, 2))
                            / scale).tolist(),
                       tokens_equal=bool(torch.equal(got_tok, want_tok)),
                       finite=bool(torch.isfinite(got).all()))
        if key == "z2_mamba2":
            kw = RUNS["a_bf16_chunked_T8"][1]
            n_req, max_new = RUNS["a_bf16_chunked_T8"][2:4]
            reqs = make_requests(cfg, n_req, 128, max_new, seed=0,
                                 arrival_every=4)
            eng = ServingEngine(build_model(cfg, dev), 8, 128, device=dev,
                                ctx=ctx, **kw)
            t0 = time.monotonic()
            st = eng.run(params, reqs)
            _sync(dev)
            res["engine"] = {"streams": [r.generated for r in reqs],
                             "host_syncs": st["host_syncs"],
                             "completed": st["completed"],
                             "tpot_mean_ms": st["tpot_mean_ms"],
                             "serve_s": time.monotonic() - t0,
                             "mesh": st["mesh"]}
            if mesh.rank == 0:
                reqs1 = make_requests(cfg, n_req, 128, max_new, seed=0,
                                      arrival_every=4)
                st1 = ServingEngine(build_model(cfg, dev), 8, 128,
                                    device=dev, **kw).run(full, reqs1)
                res["engine_unsharded"] = {
                    "streams": [r.generated for r in reqs1],
                    "host_syncs": st1["host_syncs"],
                    "tpot_mean_ms": st1["tpot_mean_ms"]}
        res["took_s"] = time.monotonic() - t_start
        out[key] = res
        del full, params, api
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def phase_pp_families(totals, runs, device="cuda", reduced=False):
    """Runs (z1)-(z4) (the module's constants above) on two ranks sharing
    the card over gloo: one launch for (z1) on (2, 1, 1), one for
    (z2)-(z4) on (1, 2). (z1): every stage's logits within the int8 rule
    of the unsharded stage loop (stored K/V bytes counted; 1e-4 of
    max|logit| until a flip, 2e-2 after), tokens exact, the pod axis
    carrying exactly B * d_model * 2 bytes a call a rank at ``pp_hop`` and
    nothing else, K1 and K4 launched on each rank; (z2)-(z4): f32 logits
    within 1e-4 of max|logit| at every step, tokens exact, each run's
    kernels launched (none for mamba2), and (z2)'s engine streams equal
    to the unsharded engine's."""
    from repro_torch.launch.mesh import launch
    if device == "cuda":
        torch.cuda.empty_cache()
    kw = dict(device=device, share_device=device == "cuda", threads=4,
              timeout_s=600, wall_s=900)
    t0 = time.monotonic()
    pp = launch(pp_rank, (PP_STAGES, 1, 1), ("pod", "data", "model"),
                (reduced,), **kw).join()
    log(f"  (z1): ranks joined after {time.monotonic() - t0:.1f}s")
    for r in pp:
        per_call = sorted(r["wall_ms"][1:])
        log(f"  (z1) PP decode rank {r['rank']} (stage {r['stage']}): "
            f"{len(r['wall_ms'])} calls, wall a call mean "
            f"{sum(per_call) / len(per_call):.3f} ms, p50 "
            f"{per_call[len(per_call) // 2]:.3f} ms (first call "
            f"{r['wall_ms'][0]:.1f} ms); pod bytes {r['pod_bytes']}, "
            f"other axes {r['other_bytes']}; one hop alone "
            f"{r['hop_ms']:.3f} ms; launches {r['counts']}; stage logits "
            f"max |dlogit|/max|logit| {max(r['rel']):.3e} against the "
            f"unsharded stage loop, tokens equal {r['tokens_equal']}, "
            f"stored K/V bytes flipped {r['flips']}; {r['took_s']:.1f}s")
        hop = PP_CALLS * PP_B * r["d_model"] * r["itemsize"]
        require(r["pod_bytes"] == {"pp_hop": hop},
                f"(z1) rank {r['rank']}: the pod axis carried "
                f"{r['pod_bytes']}, not {hop} B at pp_hop")
        require(r["length"] == PP_CALLS, "(z1): a stage's cursor is off")
        require(r["tokens_equal"], f"(z1) stage {r['stage']}: tokens differ")
        rtol = 1e-4 if r["flips"] == 0 else 2e-2
        require(max(r["rel"]) <= rtol, f"(z1) stage {r['stage']}: logits "
                f"beyond the int8 rule ({max(r['rel']):.3e})")
        require(device != "cuda" or (r["counts"]["flash_decode"] > 0
                                     and r["counts"]["gemv_int8"] > 0),
                f"(z1) rank {r['rank']}: K1 or K4 never launched")
        key = f"z1_pp_decode_rank{r['rank']}"
        runs[key] = r["counts"]
        for k, n in r["counts"].items():
            totals[k] += n
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    fam = launch(fam_mesh_rank, (1, 2), ("data", "model"), (reduced,),
                 **kw).join()
    log(f"  (z2)-(z4): ranks joined after {time.monotonic() - t0:.1f}s")
    r0 = fam[0]
    for key, (arch, layers) in FAM_MESH_RUNS.items():
        z = r0[key]
        log(f"  ({key}) {arch} x {layers} layers (1,2) sub_operator f32: "
            f"max |dlogit|/max|logit| {max(z['rel']):.3e} over "
            f"{len(z['rel'])} steps, tokens equal {z['tokens_equal']}, "
            f"{z['ms_per_step']:.1f} ms a step; bytes by site "
            f"{json.dumps(z['bytes_per_site'])}; {z['took_s']:.1f}s")
        require(z["finite"] and z["tokens_equal"],
                f"({key}): tokens differ from the unsharded run")
        require(max(z["rel"]) <= 1e-4, f"({key}): logits differ")
        for r in fam:
            c = r[key]["counts"]
            need = FAM_MESH_KERNELS[key]
            log(f"    rank {r['rank']}: launches {c}")
            require(device != "cuda" or all((n > 0) == (k in need)
                                            for k, n in c.items()),
                    f"({key}) rank {r['rank']}: launched {c}, its path "
                    f"runs {need}")
            runs[f"{key}_rank{r['rank']}"] = c
            for k, n in c.items():
                totals[k] += n
    e, e1 = r0["z2_mamba2"]["engine"], r0["z2_mamba2"]["engine_unsharded"]
    log(f"  (z2) engine on (a)'s plan, (1,2): host syncs {e['host_syncs']}"
        f" (unsharded {e1['host_syncs']}), TPOT mean "
        f"{e['tpot_mean_ms']:.3f} ms (unsharded {e1['tpot_mean_ms']:.3f}),"
        f" serve {e['serve_s']:.1f}s, collective bytes "
        f"{e['mesh']['bytes_total']:.0f} in {e['mesh']['calls']} calls")
    require(e["completed"] == RUNS["a_bf16_chunked_T8"][2],
            "(z2): not every request completed")
    require(e["streams"] == e1["streams"], "(z2): the engine's streams "
            "differ from the unsharded engine's")
    require(e["host_syncs"] == e1["host_syncs"], "(z2): host syncs differ")


def phase_compare_pp_families(dev, errs):
    """Phase 2 at the shapes phase 4d gives the kernels: K1 over the
    hybrid's ring at G=8 hd 256 (one rank's 8 query heads on the one KV
    head: two head runs of 4), B 2 and 8, ring 192, cursor at 0, mid,
    last and wrapped, f32 / bf16 / int8 KV; K1 at whisper's 8 heads a
    rank (G=1, hd 64, 8 KV heads) over the 1,500 cross frames (every
    position live) and over the self cache (192 positions, rows live up
    to 80); K3 gelu at one rank's half of recurrentgemma's F (D=4096,
    F=6144) in f32 at 2 and 128 rows and bf16 at 8; K1 at one PP stage's
    llama3.2-3b shape (24 query heads on 8 KV heads of 128, B=8, bf16 q,
    int8 KV, S=192) and K4 at its projections (3072x3072, 3072x1024,
    8192x3072; 3072x8192 is phase 2's Llama row) at 8 rows, exact.
    Tolerances as in ``phase_compare``; every case repeats bit for bit."""
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    from repro_torch.kernels.gemv.ops import gemv_int8_q
    from repro_torch.kernels.gemv.ref import gemv_int8_ref
    S = 192
    for B in (2, 8):
        for pair in (("float32", "float32"), ("bfloat16", "bfloat16"),
                     ("bfloat16", "int8")):
            err = ratio = 0.0
            same = True
            for pos, window in ((0, S), (S // 2, S), (S - 1, S),
                                (S + S // 3, S)):
                args = ring_inputs(dev, B, S, pair, pos, window, 8, 1,
                                   seed=B + pos)
                e, e_p, r, sm = check_k1(args, min(pos + 1, S))
                err, ratio = max(err, e, e_p), max(ratio, r)
                same = same and sm
            errs["flash_decode"] = max(errs["flash_decode"], err)
            log(f"  K1 ring G=8 hd=256 B={B} S={S} {pair[0]}/{pair[1]}: "
                f"max|d|={err:.3g}, max|d|/tol={ratio:.3g}, repeat "
                f"identical={same}")
            require(ratio <= 1.0 and same, f"K1 ring G=8 B={B} {pair}")
    for S, lim in ((1500, None), (192, 80)):
        for pair in (("float32", "float32"), ("bfloat16", "bfloat16")):
            args = k1_inputs(dev, 2, S, pair, lim, Hq=8, n_kv=8, hd=64)
            e, e_p, r, sm = check_k1(args, int(args[-1]))
            errs["flash_decode"] = max(errs["flash_decode"], e)
            log(f"  K1 whisper rank B=2 Hq=8 n_kv=8 hd=64 S={S} "
                f"{pair[0]}: max|d|={max(e, e_p):.3g}, max|d|/tol={r:.3g}, "
                f"repeat identical={sm}")
            require(r <= 1.0 and sm, f"K1 whisper rank S={S} {pair}")
    args = k1_inputs(dev, 8, 192, ("bfloat16", "int8"), Hq=24, n_kv=8,
                     hd=128)
    e, e_p, r, sm = check_k1(args, int(args[-1]))
    log(f"  K1 PP stage B=8 Hq=24 n_kv=8 hd=128 S=192 bf16/int8: "
        f"max|d|={max(e, e_p):.3g}, max|d|/tol={r:.3g}, repeat "
        f"identical={sm}")
    require(r <= 1.0 and sm, "K1 at the PP stage's shape")
    for R, dt in ((2, torch.float32), (128, torch.float32),
                  (8, torch.bfloat16)):
        args, _ = k3_inputs(dev, R, seed=R, D=4096, F=6144, dtype=dt)
        got = fused_ffn(*args, act="gelu")
        want = fused_ffn_ref(*args, act="gelu")
        e, tol = max_err(got, want), 1e-4 * max(1, max_abs(want))
        same = torch.equal(fused_ffn(*args, act="gelu"), got)
        errs["fused_ffn"] = max(errs["fused_ffn"], e)
        log(f"  K3 gelu D=4096 F=6144 {str(dt)[6:]} rows={R}: "
            f"max|d|={e:.3g} (tol {tol:.3g}), repeat identical={same}")
        require(e <= tol and same, f"K3 gelu F=6144 rows={R}")
    for K, N in ((3072, 3072), (3072, 1024), (8192, 3072)):
        args, _ = k4_inputs(dev, 8, K, N)
        got, want = gemv_int8_q(*args), gemv_int8_ref(*args)
        log(f"  K4 PP stage rows=8 K={K} N={N}: exact "
            f"{torch.equal(got, want)}")
        require(torch.equal(got, want), f"K4 at {K}x{N}")
    torch.cuda.synchronize()


def pp_family_timing_rows(dev, bound, sdpa_args):
    """Phase 5 rows at phase 4d's shapes: K1 over the ring at G=8 hd 256
    ((z3): B=2, ring 192, f32), K1 at whisper's 8 heads a rank over the
    1,500 cross frames and the self cache ((z4): B=2, f32), K3 gelu at
    D=4096 F=6144 ((z3): f32 at 2 and 128 rows), and K1 at a PP stage's
    shape ((z1): B=8, Hq=24 n_kv=8 hd=128, bf16 q / int8 KV, S=192)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    rows = []

    def k1_row(label, make, dt):
        # K1 loads no tile at or past kv_limit: the bound counts the K/V,
        # their scales and the mask below it, and the work of those
        # positions only.
        args = make(0)
        q, k, v, mask, ks, vs, lim = args[:7]
        live = min(int(lim), k.shape[2])
        below = [None if t is None else t.narrow(2, 0, live)
                 for t in (k, v, ks, vs)]
        nb = (nbytes(q, mask.narrow(1, 0, live), lim, *below)
              + q.numel() * 4)
        b_ms, b_by = bound(nb, 4 * q.shape[0] * q.shape[1] * live
                           * q.shape[2], dt)
        var = variants_of(lambda i: (make(i), {}), nb)
        lib = {"sdpa(enable_gqa)": time_ms(F.scaled_dot_product_attention,
                                           sdpa_args(var), 400)}
        rows.append(("flash_decode", label, time_ms(flash_decode, var, 400),
                     time_ms(flash_decode_ref, var, 50), b_ms, b_by, lib,
                     host_ms(flash_decode, var)))
    k1_row("ring G=8 hd=256 (z3, one rank): B=2 S=192 f32",
           lambda i: ring_inputs(dev, 2, 192, ("float32", "float32"), 80,
                                 192, 8, 1, seed=i), torch.float32)
    k1_row("whisper rank cross (z4): B=2 Hq=8 n_kv=8 hd=64 S=1500 f32",
           lambda i: k1_inputs(dev, 2, 1500, ("float32", "float32"),
                               Hq=8, n_kv=8, hd=64, seed=i),
           torch.float32)
    k1_row("whisper rank self (z4): B=2 Hq=8 n_kv=8 hd=64 S=192 f32",
           lambda i: k1_inputs(dev, 2, 192, ("float32", "float32"), 80,
                               Hq=8, n_kv=8, hd=64, seed=i),
           torch.float32)
    k1_row("PP stage (z1): B=8 Hq=24 n_kv=8 hd=128 S=192 bf16/int8",
           lambda i: k1_inputs(dev, 8, 192, ("bfloat16", "int8"), Hq=24,
                               n_kv=8, hd=128, seed=i), torch.bfloat16)
    for R in (2, 128):
        (x, wg, wu, wd), _ = k3_inputs(dev, R, D=4096, F=6144,
                                       dtype=torch.float32)
        nb = nbytes(x, wg, wu, wd) + R * 4096 * 4
        b_ms, b_by = bound(nb, 2 * R * 4096 * 6144 * 3, torch.float32)
        var = variants_of(lambda i: ((k3_inputs(
            dev, R, seed=i, D=4096, F=6144, dtype=torch.float32)[0]),
            dict(act="gelu")), nb)

        def lib_ffn(x, wg, wu, wd, act="gelu"):
            return torch.matmul(F.gelu(torch.matmul(x, wg),
                                       approximate="tanh")
                                * torch.matmul(x, wu), wd)
        lib = {"3x torch.matmul + gelu (f32)": time_ms(lib_ffn, var, 100)}
        rows.append(("fused_ffn", f"gelu, one rank's half of F (z3): "
                     f"rows={R} D=4096 F=6144 f32",
                     time_ms(fused_ffn, var, 100),
                     time_ms(fused_ffn_ref, var, 20), b_ms, b_by, lib,
                     host_ms(fused_ffn, var)))
    return rows


# ---------------------------------------------------------------------------
# phase 4e: the recurrent and enc-dec families trained on a mesh, and
# recurrentgemma served in drain mode on a mesh, two ranks sharing the
# card (gloo)
# ---------------------------------------------------------------------------

# full width, cut in depth, f32, seeded weights, the synthetic data of
# ``launch.train``; ``make_step(mode="train")`` under sub_operator+fsdp,
# held each step to the same steps unsharded in one process (rank 0):
# (z5) mamba2-1.3b 2 of 48 layers on (2, 1), fsdp over the data axis,
# 4 x 128; (z6) recurrentgemma-9b one superblock (3 of 38 layers) on
# (1, 2), 2 x 128 (K3 gelu with a gradient on half of F a rank, the
# RG-LRU channels and the 256,000-row vocabulary cut over the model
# axis); (z7) whisper-medium 2 + 2 of 24 + 24 layers, 1,500 frames, on
# (2, 1), 2 x 64. (z8): recurrentgemma-9b (one superblock, f32) through
# ``ServingEngine`` on (1, 2) (``auto`` resolves to drain) on run (p)'s
# plan, against the unsharded engine on rank 0
FAM_TRAIN_RUNS = {
    # key: (arch, layers, mesh grid, batch, seq, steps, kernels)
    "z5_mamba2_train": ("mamba2-1.3b", 2, (2, 1), 4, 128, 3, ()),
    "z6_recurrentgemma_train": ("recurrentgemma-9b", 3, (1, 2), 2, 128, 2,
                                ("fused_ffn",)),
    "z7_whisper_train": ("whisper-medium", 2, (2, 1), 2, 64, 2, ()),
}
FAM_TRAIN_LOSS_RTOL, FAM_TRAIN_GNORM_RTOL = 2e-5, 2e-4
DRAIN_MESH_RUN = ("z8_recurrentgemma_drain", "recurrentgemma-9b", 3,
                  ("flash_decode", "fused_ffn"))


def _fam_train_batches(cfg, B, S, steps, dev):
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.launch.train import batch_to_torch
    data = SyntheticLMData(cfg, B, S, seed=0)
    return [batch_to_torch(data.batch_at(i), dev) for i in range(steps)]


def _fam_train_run(mesh, meshes, key, reduced):
    """One of (z5)-(z7) on this rank: the sharded steps
    (``_train_mesh_steps``) and, on rank 0, the unsharded steps."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.execution import make_step
    from repro_torch.models.param_specs import shard_params
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init
    arch, layers, grid, B, S, steps, _ = FAM_TRAIN_RUNS[key]
    dev = mesh.device
    t0 = time.monotonic()
    cfg = _fam_cfg(arch, layers, reduced)
    full = build_model(cfg, dev).init(0)
    batches = _fam_train_batches(cfg, B, S, steps, dev)
    bundle = make_step(cfg, ShapeConfig("t", S, B, "train"), meshes[grid],
                       "sub_operator")
    params = shard_params(full, bundle.ctx)
    if mesh.rank:
        del full
    res = _train_mesh_steps(bundle, cfg, params, adamw_init(params),
                            batches)
    res["rules"] = bundle.ctx.rules.name
    del params, bundle
    if mesh.rank == 0:
        # the unsharded steps hold one copy of the weights
        whole, full = full, None
        res["unsharded"] = _unsharded_steps(cfg, whole, batches, dev)
        del whole
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res["took_s"] = time.monotonic() - t0
    return res


def _drain_mesh_run(mesh, m12, reduced):
    """(z8) on this rank: recurrentgemma through the engine on (1, 2)
    under sub_operator, ``mode="auto"``, run (p)'s plan (12 requests of
    prompt 128 and 32 new tokens, arrivals every 4 steps, 8 slots); on
    rank 0 the unsharded engine on the same plan."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.param_specs import shard_params
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import ShardingCtx, sub_operator
    from repro_torch.runtime.serving import ServingEngine
    _, arch, layers, _ = DRAIN_MESH_RUN
    _, _, kw, n_req, max_new, _ = RECURRENT_RUNS[
        "p_recurrentgemma_auto_drain"]
    dev = mesh.device
    t0 = time.monotonic()
    cfg = _fam_cfg(arch, layers, reduced)
    ctx = ShardingCtx(m12, sub_operator())
    full = build_model(cfg, dev).init(0)
    params = shard_params(full, ctx)
    if mesh.rank:
        del full
    reqs = make_requests(cfg, n_req, 128, max_new, seed=0, arrival_every=4)
    eng = ServingEngine(build_model(cfg, dev), 8, 128, device=dev, ctx=ctx,
                        **kw)
    _sync(dev)
    reset_launch_counts()
    t1 = time.monotonic()
    st = eng.run(params, reqs)
    _sync(dev)
    res = {"streams": [r.generated for r in reqs], "counts": launch_counts(),
           "host_syncs": st["host_syncs"], "completed": st["completed"],
           "mode": st["mode"], "tpot_mean_ms": st["tpot_mean_ms"],
           "decode_steps": st["decode_steps"],
           "serve_s": time.monotonic() - t1, "mesh": st["mesh"],
           "programs": {k: v["calls"] for k, v in st["runtime"].items()}}
    del params, eng
    if mesh.rank == 0:
        reqs1 = make_requests(cfg, n_req, 128, max_new, seed=0,
                              arrival_every=4)
        st1 = ServingEngine(build_model(cfg, dev), 8, 128, device=dev,
                            **kw).run(full, reqs1)
        res["unsharded"] = {"streams": [r.generated for r in reqs1],
                            "host_syncs": st1["host_syncs"],
                            "tpot_mean_ms": st1["tpot_mean_ms"]}
        del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res["took_s"] = time.monotonic() - t0
    return res


def fam_train_rank(mesh, reduced=False):
    """One rank of phase 4e: (z5)-(z7) on their meshes (the launch's
    (2, 1) and a (1, 2) mesh over the same two ranks), then (z8).
    ``reduced``: the reduced configs, for a rehearsal on the CPU."""
    from repro_torch.launch.mesh import Mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {mesh.devices_shape: mesh}
    meshes[(1, 2)] = Mesh((1, 2), ("data", "model"), mesh.device)
    out = {"rank": mesh.rank}
    for key in FAM_TRAIN_RUNS:
        out[key] = _fam_train_run(mesh, meshes, key, reduced)
    out[DRAIN_MESH_RUN[0]] = _drain_mesh_run(mesh, meshes[(1, 2)], reduced)
    return out


def phase_fam_train_mesh(totals, runs, device="cuda", reduced=False):
    """Runs (z5)-(z8) (the module's constants above) on two ranks sharing
    the card over gloo, one launch: (z5)-(z7) each step's loss within 2e-5
    and grad norm within 2e-4 (relative) of the same steps unsharded,
    their kernels launched (K3 in (z6); none in (z5), whose SSD has no
    kernel, or (z7), whose training attention is autograd of one softmax
    and whose MLP is ungated), the fsdp bytes a rank a step printed; (z8)
    ``auto`` resolves to drain, every request completes, the streams and
    host syncs equal the unsharded engine's, K1 (the ring) and K3 (gelu)
    launched on each rank."""
    from repro_torch.launch.mesh import launch
    if device == "cuda":
        torch.cuda.empty_cache()
    kw = dict(device=device, share_device=device == "cuda", threads=4,
              timeout_s=600, wall_s=900)
    t0 = time.monotonic()
    res = launch(fam_train_rank, (2, 1), ("data", "model"), (reduced,),
                 **kw).join()
    log(f"  (z5)-(z8): ranks joined after {time.monotonic() - t0:.1f}s")
    r0 = res[0]
    for key, (arch, layers, grid, B, S, steps, need) in \
            FAM_TRAIN_RUNS.items():
        z, un = r0[key], r0[key]["unsharded"]
        log(f"  ({key}) {arch} x {layers} layers, {grid} {z['rules']}, "
            f"f32, {B} x {S}, {steps} steps: losses "
            f"{[x for x, _ in z['steps']]} (unsharded "
            f"{[x for x, _ in un['steps']]}), grad norms "
            f"{[g for _, g in z['steps']]} (unsharded "
            f"{[g for _, g in un['steps']]}); unsharded "
            f"{un['ms_per_step']:.1f} ms a step, peak memory "
            f"{un['peak_gib']:.2f} GiB; {z['took_s']:.1f}s")
        for i, ((gl, gn), (wl, wn)) in enumerate(zip(z["steps"],
                                                     un["steps"]), 1):
            require(np.isfinite(gl) and abs(gl - wl)
                    <= FAM_TRAIN_LOSS_RTOL * abs(wl),
                    f"({key}) step {i}: loss {gl} vs unsharded {wl}")
            require(abs(gn - wn) <= FAM_TRAIN_GNORM_RTOL * abs(wn),
                    f"({key}) step {i}: grad norm {gn} vs unsharded {wn}")
        require(len(z["steps"]) == steps == len(un["steps"]),
                f"({key}): not every step ran")
        for r in res:
            run = r[key]
            fsdp = [run["sites"].get(s, (0, 0.0))
                    for s in ("fsdp_gather", "fsdp_gather.grad")]
            log(f"    rank {r['rank']}: {run['ms_per_step']:.1f} ms a step, "
                f"peak memory {run['peak_gib']:.2f} GiB, launches "
                f"{run['counts']}; fsdp bytes a step: gathers "
                f"{fsdp[0][1]:.0f} B in {fsdp[0][0]:g} calls, "
                f"reduce-scatters {fsdp[1][1]:.0f} B in {fsdp[1][0]:g} "
                f"calls")
            log(f"      collectives a step by site (calls, bytes): "
                + ", ".join(f"{s} {c:g} / {b:.0f}" for s, (c, b) in
                            sorted(run["sites"].items())))
            c = run["counts"]
            require(device != "cuda" or all((n > 0) == (k in need)
                                            for k, n in c.items()),
                    f"({key}) rank {r['rank']}: launched {c}, its path "
                    f"runs {need}")
            require(grid[0] == 1 or fsdp[0][1] > 0,
                    f"({key}) rank {r['rank']}: no fsdp gather on {grid}")
            runs[f"{key}_rank{r['rank']}"] = c
            for k, n in c.items():
                totals[k] += n
    key, arch, layers, need = DRAIN_MESH_RUN
    z = r0[key]
    un = z["unsharded"]
    log(f"  ({key}) {arch} x {layers} layers (1,2) sub_operator f32, run "
        f"(p)'s plan: mode {z['mode']}, {z['completed']} completed, "
        f"{z['decode_steps']} decode steps, host syncs {z['host_syncs']} "
        f"(unsharded {un['host_syncs']}), TPOT mean "
        f"{z['tpot_mean_ms']:.3f} ms (unsharded {un['tpot_mean_ms']:.3f}),"
        f" serve {z['serve_s']:.1f}s, collective bytes "
        f"{z['mesh']['bytes_total']:.0f} in {z['mesh']['calls']} calls, "
        f"programs {z['programs']}; {z['took_s']:.1f}s")
    n_req = RECURRENT_RUNS["p_recurrentgemma_auto_drain"][3]
    require(z["mode"] == "drain", f"({key}): auto resolved to {z['mode']}")
    require(z["completed"] == n_req, f"({key}): not every request completed")
    require(z["streams"] == un["streams"], f"({key}): the engine's streams "
            "differ from the unsharded engine's")
    require(z["host_syncs"] == un["host_syncs"], f"({key}): host syncs "
            "differ from the unsharded engine's")
    for r in res:
        c = r[key]["counts"]
        log(f"    rank {r['rank']}: launches {c}")
        require(r[key]["streams"] == z["streams"],
                f"({key}): the ranks' streams differ")
        require(device != "cuda" or all((n > 0) == (k in need)
                                        for k, n in c.items()),
                f"({key}) rank {r['rank']}: launched {c}, its path runs "
                f"{need}")
        runs[f"{key}_rank{r['rank']}"] = c
        for k, n in c.items():
            totals[k] += n


def fam_train_timing_rows(dev, bound):
    """Phase 5 rows at phase 4e's and phase 4d's remaining shapes: K3 gelu
    at one rank of (z6) (256 rows, D=4,096, F=6,144 of 12,288, f32; the
    forward, which the ``FusedFFN`` backward does not relaunch) against
    three f32 matmuls and gelu; K4 at a PP stage's projections of (z1)
    (llama3.2-3b wq/wo 3072x3072, wk/wv 3072x1024, w_down 8192x3072) at 8
    rows against a bf16 matmul on the dequantized weights."""
    import torch.nn.functional as F
    from repro_torch.kernels.fused_ffn.ops import fused_ffn
    from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref
    from repro_torch.kernels.gemv.ops import gemv_int8_q
    from repro_torch.kernels.gemv.ref import gemv_int8_ref
    rows = []
    R, D, Fd = Z6_K3
    (x, wg, wu, wd), _ = k3_inputs(dev, R, D=D, F=Fd, dtype=torch.float32)
    nb = nbytes(x, wg, wu, wd) + R * D * 4
    b_ms, b_by = bound(nb, 2 * R * D * Fd * 3, torch.float32)
    var = variants_of(lambda i: ((k3_inputs(dev, R, seed=i, D=D, F=Fd,
                                            dtype=torch.float32)[0]),
                                 dict(act="gelu")), nb)

    def lib_ffn(x, wg, wu, wd, act="gelu"):
        return torch.matmul(F.gelu(torch.matmul(x, wg), approximate="tanh")
                            * torch.matmul(x, wu), wd)
    lib = {"3x torch.matmul + gelu (f32)": time_ms(lib_ffn, var, 50)}
    rows.append(("fused_ffn", f"gelu, one training rank of (z6): rows={R} "
                 f"D={D} F={Fd} f32", time_ms(fused_ffn, var, 50),
                 time_ms(fused_ffn_ref, var, 10), b_ms, b_by, lib,
                 host_ms(fused_ffn, var)))
    for K, N in ((3072, 3072), (3072, 1024), (8192, 3072)):
        (xq, xs, wq, ws), _ = k4_inputs(dev, 8, K, N)
        nb = nbytes(xq, xs, wq, ws) + 8 * N * 4
        b_ms, b_by = bound(nb, 2 * 8 * K * N, torch.int8)
        var = variants_of(lambda i: k4_inputs(dev, 8, K, N, seed=i), nb)
        dq = [((a[0].to(torch.bfloat16),
                (a[2].float() * a[3]).to(torch.bfloat16)), {})
              for a, _ in var]
        lib = {"bf16 torch.matmul on dequantized weights":
               time_ms(torch.matmul, dq, 400)}
        rows.append(("gemv_int8", f"PP stage (z1): rows=8 K={K} N={N}",
                     time_ms(gemv_int8_q, var, 400),
                     time_ms(gemv_int8_ref, var, 50), b_ms, b_by, lib,
                     host_ms(gemv_int8_q, var)))
    return rows


# ---------------------------------------------------------------------------
# phase 4f: preemption, the tiered KV cache and KV budgets on a mesh of two
# ranks sharing the card (gloo)
# ---------------------------------------------------------------------------

# qwen2-0.5b at full width (D 896, 14 query heads on 2 KV heads of 64, F
# 4,864, V 151,936), 2 of its 24 layers, f32 (no TF32), seeded weights, a
# tiered cache of hot window 64 and cold blocks of 16 (a ring of 80), 8
# slots, prompt width 128, blocks of 8, buckets of 64, chunks of 32, the
# KV extent 200. Each run is held to the same engine and plan unsharded on
# rank 0: streams exact, the same preemptions, swaps, demotions and peak
# bytes.
TIER_MESH_LAYERS = 2
TIER_MESH_TIERS = dict(hot_window=64, kv_cold_block=16)
TIER_MESH_KW = dict(block_size=8, kv_bucket_chunk=64, prefill_chunk=32,
                    max_new_cap=72, preemptible=True)
# (z9) serves (h)'s plan (12 requests of prompt 128 and 32 new tokens,
# arrivals every 4 steps) through the chunk lane, which admits one chunk a
# boundary while a slot decodes: at most two slots decode at once, one
# near cursor 160 and one just admitted (1.07 slot prices at cursor 160 at
# the peak, in the plan's CPU rehearsal). A budget of 1.06 such prices
# binds whenever two do (12 preemptions and restores in the rehearsal).
Z9_BUDGET_PRICES = 1.06
# (z10) and (z11)'s priority plan: 8 requests of priority 0 (prompt 64; 48
# new tokens in slots 0-3, 16 in slots 4-7) at step 0, then 2 of priority
# 5 (prompt 32, 16 new tokens) at step 24: the two most recently admitted
# decoders (slots 1 and 0, data row 0 on (2, 1)) are swapped out, and one
# is restored into slot 4, on the other data row (the CPU rehearsal)
PRIO_NEW, PRIO_ARRIVAL, PRIO_HI = (48,) * 4 + (16,) * 4, 24, (2, 32, 16)
TIER_MESH_RUNS = {
    # key: (mesh grid, executor, backend, cold dtype, int8 weights, plan,
    #       kernels of its path; ``flash_decode`` counts every K1 launch,
    #       the partial ones too)
    "z9_tiered_int4_seqkv_budget": (
        (1, 2), "sub_operator+seqkv", "colocated", "int4", False, "h",
        ("flash_decode", "flash_decode_partial", "fused_ffn")),
    "z10_int8w_int8cold_priority": (
        (2, 1), "sub_operator", "colocated", "int8", True, "priority",
        ("flash_decode", "gemv_int8")),
    "z11_wa_tiered_int8_priority": (
        (1, 2), "sub_operator", "wa", "int8", False, "priority",
        ("flash_decode", "flash_decode_partial", "fused_ffn")),
}
# (f)'s chaos schedule on (1, 2) under sub_operator over 4 slots: the plan
# of F_SEED with its scripted priority-3 arrival, int8 KV, F_ENGINE
CHAOS_MESH_KEY = "z12_chaos_int8kv_sub_operator"
CHAOS_MESH_KERNELS = ("flash_decode", "fused_ffn")
def _tier_mesh_cfg(reduced, **over):
    """qwen2-0.5b at TIER_MESH_LAYERS layers in f32; ``reduced``: the
    reduced config with the full config's KV heads and head_dim (the
    arbiter's prices and so the schedule are the full width's), for a
    rehearsal on the CPU."""
    from repro_torch.configs.registry import get_config
    base = get_config("qwen2-0.5b")
    if reduced:
        base = base.reduced().replace(head_dim=64)
    return base.replace(n_layers=TIER_MESH_LAYERS, dtype="float32", **over)


def _tier_plan(cfg, plan):
    from repro_torch.launch.serve import make_requests
    from repro_torch.runtime.serving import Request
    if plan == "h":
        return make_requests(cfg, 12, 128, 32, seed=0, arrival_every=4)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 64,
                                               dtype=np.int32),
                    max_new_tokens=n, arrival_step=0)
            for i, n in enumerate(PRIO_NEW)]
    n_hi, plen, new = PRIO_HI
    reqs += [Request(rid=len(PRIO_NEW) + j, prompt=rng.integers(
        0, cfg.vocab_size, plen, dtype=np.int32), max_new_tokens=new,
        arrival_step=PRIO_ARRIVAL, priority=5) for j in range(n_hi)]
    return reqs


def _swap_clock(eng):
    """Host ms of each swap-out (export + copy to the host + the ranks'
    vote) and swap-in (staging + copy back + masked write) of ``eng``."""
    ms = {"out": [], "in": []}

    def timed(fn, key):
        def wrapper(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper
    eng._preempt_slot = timed(eng._preempt_slot, "out")
    eng._restore = timed(eng._restore, "in")
    return ms


def _count_moves():
    """Count the swap images restored into another data row than the one
    that swapped them out (``ExecutorBackend.stage_image``)."""
    from repro_torch.runtime import serving
    moves = [0]
    inner = serving.ExecutorBackend.stage_image

    def stage(self, saved, slot):
        if isinstance(saved, serving.RankImage) and \
                saved.row != slot // self.local_slots:
            moves[0] += 1
        return inner(self, saved, slot)
    serving.ExecutorBackend.stage_image = stage
    return moves


def _tier_serve(cfg, params, ctx, dev, kw, plan, moves=None):
    """One engine run of ``plan``: what phase 4f compares and prints."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.serving import ServingEngine
    reqs = _tier_plan(cfg, plan)
    eng = ServingEngine(build_model(cfg, dev), 8, 128, device=dev, ctx=ctx,
                        **kw)
    swaps = _swap_clock(eng)
    n0 = moves[0] if moves else 0
    _sync(dev)
    reset_launch_counts()
    t0 = time.monotonic()
    st = eng.run(params, reqs)
    _sync(dev)
    rt = st["runtime"]
    pre = eng._ex.program_prefix
    return {"streams": [list(r.generated) for r in reqs],
            "statuses": [r.status for r in reqs],
            "preemptions": [r.preemptions for r in reqs],
            "counts": launch_counts(), "serve_s": time.monotonic() - t0,
            "stats": {k: st[k] for k in ("completed", "preemptions",
                                         "restores", "host_syncs",
                                         "tpot_mean_ms", "decode_steps")},
            "swap_calls": [rt[pre + "swap_out"]["calls"],
                           rt[pre + "swap_in"]["calls"]],
            "swap_ms": {k: float(np.mean(v)) if v else float("nan")
                        for k, v in swaps.items()},
            "tiered": {k: st["tiered"][k] for k in
                       ("demotions", "peak_kv_bytes", "cold_bytes_saved",
                        "kv_budget_bytes")},
            "mesh": st.get("mesh"),
            "moves": (moves[0] - n0) if moves else 0}


def _tier_mesh_run(mesh, meshes, key, reduced, moves):
    """One of (z9)-(z11) on this rank and, on rank 0, unsharded."""
    from repro_torch.core.execution import make_rules
    from repro_torch.models.param_specs import shard_params
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import ShardingCtx
    from repro_torch.runtime.serving import KVArbiter
    grid, executor, backend, cold, int8w, plan, _ = TIER_MESH_RUNS[key]
    dev = mesh.device
    t0 = time.monotonic()
    cfg = _tier_mesh_cfg(reduced, kv_cold_dtype=cold, weight_int8=int8w,
                         **TIER_MESH_TIERS)
    m = meshes[grid]
    ctx = ShardingCtx(m, make_rules(executor, m))
    full = build_model(cfg, dev).init(0)
    params = shard_params(full, ctx)
    kw = dict(TIER_MESH_KW, backend=backend)
    if plan == "h":
        arb = KVArbiter(build_model(cfg, dev).init_caches(8, 200,
                                                          device="meta"))
        arb.observe(0, 160)
        kw["kv_budget_bytes"] = int(Z9_BUDGET_PRICES
                                    * arb.slot_occupancy(0)["kv_bytes"])
    else:
        kw["strict_invariants"] = True
    res = _tier_serve(cfg, params, ctx, dev, kw, plan, moves)
    res["rules"] = ctx.rules.name
    un = None
    if mesh.rank == 0:
        res["unsharded"] = un = _tier_serve(cfg, full, None, dev, kw, plan)
    res["replays"] = _flip_rule(
        mesh, cfg, params, full if mesh.rank == 0 else None, ctx, backend,
        [r.prompt for r in _tier_plan(cfg, plan)], res["streams"],
        un["streams"] if un else None, dev)
    del params, full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res["took_s"] = time.monotonic() - t0
    return res


def _chaos_mesh_run(mesh, reduced):
    """(f)'s chaos schedule through ``run_chaos`` on (1, 2) under
    sub_operator, 4 slots, int8 KV; on rank 0 also unsharded. Returns the
    report, both runs' streams, statuses and launch counts."""
    import dataclasses
    from repro_torch.core.execution import make_rules
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.param_specs import shard_params
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import ShardingCtx
    from repro_torch.runtime import faults
    from repro_torch.runtime.serving import Request, ServingEngine
    dev = mesh.device
    t0 = time.monotonic()
    cfg = _tier_mesh_cfg(reduced, kv_dtype="int8")
    full = build_model(cfg, dev).init(0)
    plan = dataclasses.replace(faults.FaultPlan.generate(F_SEED,
                                                         n_requests=10),
                               slow_s=0.0, deadline_frac=0.0)

    def requests():
        reqs = plan.requests(cfg.vocab_size, prompt_lo=16, prompt_hi=128)
        plen, new, arrival = F_SCRIPTED
        reqs.append(Request(rid=len(reqs), prompt=np.random.default_rng(
            F_SEED).integers(0, cfg.vocab_size, plen, dtype=np.int32),
            max_new_tokens=new, arrival_step=arrival, priority=3))
        return reqs

    def chaos(ctx, params):
        reqs = requests()
        eng = ServingEngine(build_model(cfg, dev), 4, 128, device=dev,
                            ctx=ctx, **F_ENGINE)
        per_run = []
        inner = eng.run

        def counted(p, rs, **kw):
            _sync(dev)
            reset_launch_counts()
            st = inner(p, rs, **kw)
            _sync(dev)
            per_run.append({"streams": [list(r.generated) for r in rs],
                            "statuses": [r.status for r in rs],
                            "reasons": [r.reject_reason for r in rs],
                            "counts": launch_counts(),
                            "tpot_mean_ms": st["tpot_mean_ms"]})
            return st
        eng.run = counted
        rep = faults.run_chaos(eng, params, plan, reqs)
        return {"report": rep, "clean": per_run[0], "chaos": per_run[1]}
    ctx = ShardingCtx(mesh, make_rules("sub_operator", mesh))
    params = shard_params(full, ctx)
    res = chaos(ctx, params)
    un = None
    if mesh.rank == 0:
        res["unsharded"] = un = chaos(None, full)
    # the int8 rule over the clean run (a completed chaos stream is its
    # engine's clean stream: ``check_invariants``)
    res["replays"] = _flip_rule(
        mesh, cfg, params, full, ctx, "colocated",
        [r.prompt for r in requests()], res["clean"]["streams"],
        un["clean"]["streams"] if un else None, dev)
    del params, full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res["took_s"] = time.monotonic() - t0
    return res


def tier_mesh_rank(mesh, reduced=False):
    """One rank of phase 4f: (z9)-(z11) on their meshes (the launch's
    (1, 2) and a (2, 1) mesh over the same two ranks), then the chaos
    schedule (z12) on (1, 2). ``reduced``: the reduced config, for a
    rehearsal on the CPU."""
    from repro_torch.launch.mesh import Mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {mesh.devices_shape: mesh}
    meshes[(2, 1)] = Mesh((2, 1), ("data", "model"), mesh.device)
    moves = _count_moves()
    out = {"rank": mesh.rank}
    for key in TIER_MESH_RUNS:
        out[key] = _tier_mesh_run(mesh, meshes, key, reduced, moves)
    out[CHAOS_MESH_KEY] = _chaos_mesh_run(mesh, reduced)
    return out


def phase_tier_mesh(totals, runs, device="cuda", reduced=False):
    """Runs (z9)-(z11) and the chaos schedule (z12) (the module's constants
    above) on two ranks sharing the card over gloo, one launch: every
    request completes (z12: every request is terminally accounted), each
    rank's streams equal the unsharded engine's or are held to the int8
    rule (``_hold_streams``), its per-request preemptions and statuses
    equal the unsharded engine's, as do the preemption, restore and
    swap-call counts, the arbiter's demotions and peak bytes; (z9)
    preempts under its budget, (z10) and (z11) under the priority
    arrivals, and (z10)
    restores a slot on the other data row; (z12)'s report (injected
    failures, preemptions and restores included) equals the unsharded
    one's and has no violation; every rank launches exactly its path's
    kernels. Returns the swap and TPOT numbers phase 5 prints."""
    from repro_torch.launch.mesh import launch
    if device == "cuda":
        torch.cuda.empty_cache()
    kw = dict(device=device, share_device=device == "cuda", threads=4,
              timeout_s=600, wall_s=900)
    t0 = time.monotonic()
    res = launch(tier_mesh_rank, (1, 2), ("data", "model"), (reduced,),
                 **kw).join()
    log(f"  (z9)-(z12): ranks joined after {time.monotonic() - t0:.1f}s")
    r0 = res[0]
    for key, (grid, executor, backend, cold, int8w, plan, need) in \
            TIER_MESH_RUNS.items():
        z, un = r0[key], r0[key]["unsharded"]
        log(f"  ({key}) qwen2-0.5b x {TIER_MESH_LAYERS} layers f32, {grid} "
            f"{z['rules']} {backend}, cold {cold}"
            f"{', int8 weights' if int8w else ''}, plan {plan}: "
            + json.dumps(z["stats"]) + f", swap calls {z['swap_calls']}, "
            f"tiered {json.dumps(z['tiered'])}, cross-row restores "
            f"{z['moves']}, serve {z['serve_s']:.1f}s; unsharded "
            + json.dumps(un["stats"]) + f", swap calls {un['swap_calls']}, "
            f"tiered {json.dumps(un['tiered'])}; {z['took_s']:.1f}s")
        log(f"    host ms a swap-out / swap-in: rank 0 "
            f"{z['swap_ms']['out']:.3f} / {z['swap_ms']['in']:.3f}, rank 1 "
            f"{res[1][key]['swap_ms']['out']:.3f} / "
            f"{res[1][key]['swap_ms']['in']:.3f}, unsharded "
            f"{un['swap_ms']['out']:.3f} / {un['swap_ms']['in']:.3f}; TPOT "
            f"mean {z['stats']['tpot_mean_ms']:.3f} ms (unsharded "
            f"{un['stats']['tpot_mean_ms']:.3f}); collective bytes "
            f"{z['mesh']['bytes_total']:.0f} in {z['mesh']['calls']} calls, "
            f"control calls {z['mesh']['control_calls']}")
        require(z["stats"]["completed"] == len(z["streams"]),
                f"({key}): not every request completed")
        require(z["stats"]["preemptions"] >= 1
                and z["stats"]["restores"] >= 1,
                f"({key}): no preemption and restore")
        require(z["tiered"]["demotions"] > 0,
                f"({key}): the cold boundary never moved")
        if grid[0] > 1:
            require(z["moves"] >= 1, f"({key}): no slot was restored on "
                    "the other data row")
        _hold_streams(key, [r[key]["streams"] for r in res], un["streams"],
                      z["replays"])
        for r in res:
            got = r[key]
            for what in ("statuses", "preemptions", "swap_calls", "tiered"):
                require(got[what] == un[what], f"({key}) rank {r['rank']}: "
                        f"{what} differ from the unsharded engine's")
            for what in ("preemptions", "restores", "host_syncs",
                         "completed"):
                require(got["stats"][what] == un["stats"][what],
                        f"({key}) rank {r['rank']}: {what} differ from the "
                        "unsharded engine's")
            c = got["counts"]
            log(f"    rank {r['rank']}: launches {c}")
            require(device != "cuda" or all((n > 0) == (k in need)
                                            for k, n in c.items()),
                    f"({key}) rank {r['rank']}: launched {c}, its path runs "
                    f"{need}")
            runs[f"{key}_rank{r['rank']}"] = c
            for k, n in c.items():
                totals[k] += n
    z = r0[CHAOS_MESH_KEY]
    un = z["unsharded"]
    rep = z["report"]
    log(f"  ({CHAOS_MESH_KEY}) (f)'s schedule (seed {F_SEED}) on (1, 2) "
        f"sub_operator, 4 slots, int8 KV, {TIER_MESH_LAYERS} layers f32: "
        f"report {json.dumps(rep)}; TPOT mean clean "
        f"{z['clean']['tpot_mean_ms']:.3f} ms, chaos "
        f"{z['chaos']['tpot_mean_ms']:.3f} ms (unsharded "
        f"{un['clean']['tpot_mean_ms']:.3f} / "
        f"{un['chaos']['tpot_mean_ms']:.3f}); {z['took_s']:.1f}s")
    require(rep["violations"] == [], f"({CHAOS_MESH_KEY}): invariant "
            f"violations {rep['violations']}")
    require(rep["injected"]["injected_failures"] >= 1
            and rep["preemptions"] >= 1 and rep["restores"] >= 1,
            f"({CHAOS_MESH_KEY}): no injected failure, preemption and "
            "restore")
    require(rep == un["report"], f"({CHAOS_MESH_KEY}): the report differs "
            "from the unsharded engine's")
    _hold_streams(CHAOS_MESH_KEY, [r[CHAOS_MESH_KEY]["clean"]["streams"]
                                   for r in res], un["clean"]["streams"],
                  z["replays"])
    for r in res:
        require(r[CHAOS_MESH_KEY]["chaos"]["streams"]
                == z["chaos"]["streams"], f"({CHAOS_MESH_KEY}) rank "
                f"{r['rank']}: the chaos run's streams differ from rank 0's")
    n_req = len(z["clean"]["streams"])
    require(rep["completed"] + rep["rejections"] + rep["deadline_misses"]
            == n_req, f"({CHAOS_MESH_KEY}): a request was not terminally "
            "accounted")
    for r in res:
        got = r[CHAOS_MESH_KEY]
        require(got["report"] == rep, f"({CHAOS_MESH_KEY}) rank "
                f"{r['rank']}: the report differs from rank 0's")
        for which in ("clean", "chaos"):
            for what in ("statuses", "reasons"):
                require(got[which][what] == un[which][what],
                        f"({CHAOS_MESH_KEY}) rank {r['rank']} {which} run: "
                        f"{what} differ from the unsharded engine's")
            c = got[which]["counts"]
            log(f"    rank {r['rank']} {which} run: launches {c}")
            require(device != "cuda" or all(
                (n > 0) == (k in CHAOS_MESH_KERNELS) for k, n in c.items()),
                f"({CHAOS_MESH_KEY}) rank {r['rank']}: launched {c}")
            runs[f"{CHAOS_MESH_KEY}_{which}_rank{r['rank']}"] = c
            for k, n in c.items():
                totals[k] += n
    return {key: {"swap_ms": {f"rank{r['rank']}": r[key]["swap_ms"]
                              for r in res},
                  "unsharded_swap_ms": r0[key]["unsharded"]["swap_ms"],
                  "tpot_mean_ms": r0[key]["stats"]["tpot_mean_ms"]}
            for key in TIER_MESH_RUNS}


def tier_mesh_timing_rows(dev, bound, sdpa_args):
    """Phase 5 rows of K1 at phase 4f's rank shapes: in float mode over the
    resolved f32 image one rank of (z10) attends (its data row's 4 slots,
    14 query heads on 2 KV heads of 64, bucket 192 of the extent 200), and
    in partial mode over the block of 100 positions one rank of (z9) holds
    of every slot (all 8 slots, the heads whole under +seqkv), f32."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                      flash_decode_partial)
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    rows = []
    pair = ("float32", "float32")
    for name, B, S, fn, plain, what in (
            ("flash_decode", 4, 192, flash_decode, flash_decode_ref,
             "float mode over the resolved image, one rank of (z10)"),
            ("flash_decode_partial", 8, 100, flash_decode_partial,
             lambda *a: flash_decode_ref(*a, partial_stats=True),
             "partial mode over a kv_seq block, one rank of (z9)")):
        q, k, v, mask, ks, vs, lim = k1_inputs(dev, B, S, pair)
        Hq, hd = q.shape[1], q.shape[2]
        nb = nbytes(q, k, v, mask, ks, vs) + B * Hq * (
            hd + (2 if fn is flash_decode_partial else 0)) * 4
        b_ms, b_by = bound(nb, 4 * B * Hq * S * hd, torch.float32)
        var = variants_of(lambda i: (k1_inputs(dev, B, S, pair, seed=i),
                                     {}), nb)
        lib = {"sdpa(enable_gqa), f32": time_ms(
            F.scaled_dot_product_attention, sdpa_args(var), 400)}
        rows.append((name, f"{what}: B={B} Hq=14 n_kv=2 hd=64 S={S} f32",
                     time_ms(fn, var, 400), time_ms(plain, var, 50), b_ms,
                     b_by, lib, host_ms(fn, var)))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    # the host CPU that runs the plain versions of phase 2's split-KV
    # check (ROADMAP Queue 3: an intermittent difference there)
    log(f"host: {os.cpu_count()} CPUs, torch CPU capability "
        f"{torch.backends.cpu.get_cpu_capability()}, "
        f"{torch.get_num_threads()} intra-op threads")
    t_start = time.monotonic()

    log("phase 1: build")
    t0 = time.monotonic()
    reports = build.build_all()
    log(f"  built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.monotonic() - t0:.1f}s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")

    log("phase 2: kernels against their plain versions")
    t0 = time.monotonic()
    errs = phase_compare(dev)
    phase_compare_recurrent(dev, errs)
    phase_compare_vlm_encdec(dev, errs)
    phase_compare_train(dev, errs)
    phase_compare_pp_families(dev, errs)
    log(f"  phase 2 took {time.monotonic() - t0:.1f}s")

    log("phase 3: model parity, full width, 2 layers, f32, cpu vs cuda")
    t0 = time.monotonic()
    phase_model_parity()
    phase_swap_pair()
    phase_tiered_cache()
    phase_model_parity_tiered()
    phase_wa_parity()
    log(f"  phase 3 before the MoE took {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    phase_moe_parity()
    log(f"  phase 3's MoE parity took {time.monotonic() - t0:.1f}s")
    phase_parity_recurrent()
    phase_parity_vlm_encdec()
    phase_train_parity()

    log("phase 4: engine at full qwen2-0.5b, then qwen3-moe (4 layers), "
        "phi3.5-moe (4 layers), Llama-2-7B, mamba2, recurrentgemma, "
        "internvl2 (4 layers), whisper (model level) and training (s)")
    launches = {"flash_decode": 0, "flash_decode_partial": 0,
                "fused_ffn": 0, "gemv_int8": 0}
    runs = {}
    t0 = time.monotonic()
    per_step, host_syncs = phase_engine(launches, runs)
    t1 = time.monotonic()
    phase_engine_recurrent(launches, runs, per_step,
                           host_syncs["a_bf16_chunked_T8"])
    log(f"  runs (o) and (p) took {time.monotonic() - t1:.1f}s")
    t1 = time.monotonic()
    phase_engine_vlm_encdec(launches, runs, per_step)
    log(f"  runs (q) and (r) took {time.monotonic() - t1:.1f}s")
    t1 = time.monotonic()
    phase_train_run(launches, runs, card)
    log(f"  run (s) took {time.monotonic() - t1:.1f}s")
    log(f"  main-path launches {launches}; per decode step {per_step}")
    log(f"  phase 4 took {time.monotonic() - t0:.1f}s")

    log("phase 4b: serving on a (1, 2) mesh of two ranks sharing the card "
        "(gloo): runs (t), (u), (v)")
    t0 = time.monotonic()
    phase_mesh(launches, runs)
    log(f"  phase 4b took {time.monotonic() - t0:.1f}s")

    log("phase 4c: training on meshes of two ranks sharing the card "
        "(gloo): runs (w), (x), (y)")
    t0 = time.monotonic()
    phase_train_mesh(launches, runs)
    log(f"  phase 4c took {time.monotonic() - t0:.1f}s")

    log("phase 4d: pipeline-parallel decode on a (2, 1, 1) mesh and the "
        "recurrent and enc-dec families on (1, 2), two ranks sharing the "
        "card (gloo): runs (z1)-(z4)")
    t0 = time.monotonic()
    phase_pp_families(launches, runs)
    log(f"  phase 4d took {time.monotonic() - t0:.1f}s")

    log("phase 4e: the recurrent and enc-dec families trained on meshes "
        "and recurrentgemma served in drain mode on (1, 2), two ranks "
        "sharing the card (gloo): runs (z5)-(z8)")
    t0 = time.monotonic()
    phase_fam_train_mesh(launches, runs)
    log(f"  phase 4e took {time.monotonic() - t0:.1f}s")

    log("phase 4f: preemption, the tiered KV cache and KV budgets on "
        "meshes of two ranks sharing the card (gloo): runs (z9)-(z12)")
    t0 = time.monotonic()
    tier_mesh = phase_tier_mesh(launches, runs)
    log(f"  phase 4f took {time.monotonic() - t0:.1f}s")

    log("phase 5: kernel timing")
    kernels = phase_timing(dev, launches, runs, per_step, errs)
    log("  phase 4f swaps and TPOT: " + json.dumps(tier_mesh))
    phase_hops(card)
    phase_moe_timing(card)
    log(f"total {time.monotonic() - t_start:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
