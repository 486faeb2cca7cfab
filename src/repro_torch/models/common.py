"""Building blocks: initializers, norms, RoPE and sinusoidal positions,
linear (float or int8 weights), gated activations, embedding, the decode
unembedding, the training loss (chunked cross-entropy) and ``remat``.

Port of ``repro.models.common``. Parameters are nested dicts of tensors.
On a mesh (a ``ShardingCtx`` with more than one rank) the embedding is a
masked gather of this rank's vocabulary rows followed by one reduction,
the training loss is vocabulary-parallel (``chunked_ce_loss``),
the logits stay vocabulary-sharded (``greedy`` takes the argmax across the
shards, ties to the lowest index as a whole-row argmax), and a
row-parallel linear (``linear_partial``) returns this rank's f32 partial
sum for the caller to reduce, after which the bias is added once.
JAX's rounding points are kept: every ``linear`` accumulates in f32 and
returns the compute dtype, and ``gated_act`` rounds ``silu(gate)`` to the
compute dtype before the multiply.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.gemv.ops import gemv_int8_q, gemv_int8_shared
from repro_torch.models.sharding import (NULL_CTX, ShardingCtx, axes_of,
                                         entry_of)
from repro_torch.quant.int8 import (QuantizedTensor, quantize_int8,
                                    quantize_with_amax)

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Init — fan-in scaled normal, drawn from a torch.Generator on the device
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, fan_in: Optional[int] = None
               ) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(tuple(shape), dtype=torch.float32, device=gen.device,
                    generator=gen if isinstance(gen, torch.Generator)
                    else None)
    return (w * std).to(dtype)


def make_linear(gen, d_in: int, d_out: int, dtype, *, bias: bool = False,
                int8: bool = False) -> Params:
    w = dense_init(gen, (d_in, d_out), dtype)
    p: Params = {"w": quantize_int8(w, axis=0) if int8 else w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p: Params, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out). An int8 ``QuantizedTensor``
    weight goes through K4 (f32 out, then cast); a float weight is a plain
    matmul with f32 accumulation, as JAX leaves it to XLA."""
    return linears([p], x, out_dtype)[0]


def linears(ps, x: torch.Tensor, out_dtype=None):
    """Several linears of one input (q/k/v, gate/up). With int8 weights x
    is quantized once and each weight runs K4 on the same int8 rows: the
    reference quantizes the same x once per linear, so the results are
    bit-identical."""
    out_dtype = out_dtype or x.dtype
    ws = [p["w"] for p in ps]
    if all(isinstance(w, QuantizedTensor) for w in ws):
        ys = gemv_int8_shared(x, ws)
    else:
        ys = [torch.matmul(x, w) for w in ws]
    out = []
    for p, y in zip(ps, ys):
        y = y.to(out_dtype)
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        out.append(y)
    return out


def linear_partial(p: Params, x: torch.Tensor, ctx: ShardingCtx, rows):
    """Row-parallel x @ w without bias: x holds this rank's slice of the
    input dim, w the matching rows (cut over the mesh axes ``rows``).
    Returns (this rank's f32 partial sum, ``finish``): the caller reduces
    the partial over ``rows`` and applies ``finish(sum, ctx, cut)`` to it
    (``cut``: the axes the sum's last dim lies cut over), then casts and
    adds any bias once.

    Float weights: the partial product in f32; ``finish`` is the identity.
    int8 weights: x is quantized per row with the WHOLE row's absolute
    maximum (``row_quantize``), so its scales and values are the unsharded
    ones; K4 runs with unit scales, so the partial is the float of this
    rank's integer accumulator, and ``finish`` scales the reduced
    accumulator as K4 does, ``(acc * x_scale) * w_scale``. While every
    accumulator stays below 2^24 in magnitude its float is exact, and the
    result is the unsharded layer's to the bit (the weight's column scales
    are whole: cut from the already quantized tensor).

    Rows not cut (one device, or a layer the rules leave whole): the
    product ``linear`` takes (K4 with the real scales, or a matmul in x's
    dtype), and ``finish`` is the identity."""
    w = p["w"]
    if not (ctx.active and axes_of(rows)):
        if isinstance(w, QuantizedTensor):
            return gemv_int8_shared(x, [w])[0], _identity
        return torch.matmul(x, w), _identity
    if not isinstance(w, QuantizedTensor):
        return torch.matmul(x.to(torch.float32), w.to(torch.float32)), \
            _identity
    lead = x.shape[:-1]
    xq = row_quantize(x, ctx, rows)
    acc = gemv_int8_q(xq.values, torch.ones_like(xq.scale), w.values,
                      torch.ones((1, w.values.shape[1]), dtype=torch.float32,
                                 device=x.device))
    xs, ws = xq.scale, w.scale.reshape(1, -1)

    def finish(y, ctx=NULL_CTX, cut=()):
        # y: the reduced accumulator, its last dim cut over ``cut``
        w_s = ctx.local(ws, (None, entry_of(cut))) if cut else ws
        return ((y.reshape(-1, y.shape[-1]) * xs) * w_s).reshape(y.shape)
    return acc.reshape(*lead, -1), finish


def _identity(y, ctx=NULL_CTX, cut=()):
    return y


def row_quantize(x: torch.Tensor, ctx: ShardingCtx, rows
                 ) -> QuantizedTensor:
    """Per-row int8 quantization of this rank's slice x (..., K) of rows
    cut over ``rows``, flattened to (R, K): each row's absolute maximum is
    the maximum of the slices' (all-gathered), so the scales, and the
    values of the slice, are the unsharded quantization's."""
    from repro_torch.core.collectives import all_gather
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    amax = torch.amax(xf.abs(), dim=-1, keepdim=True)
    if ctx.active and axes_of(rows):
        amax = torch.amax(all_gather(amax, ctx.mesh, axes_of(rows), 1,
                                     "int8_row_amax"), dim=1, keepdim=True)
    return quantize_with_amax(xf, amax)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def make_norm(kind: str, d: int, dtype, device) -> Params:
    """RMSNorm takes a scale; LayerNorm a scale and a bias."""
    p: Params = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(kind: str, p: Params, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    """RMSNorm or LayerNorm in f32, returned in x's dtype."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (n * p["scale"].to(torch.float32)).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    n = (xf - mu) * torch.rsqrt(var + eps)
    return (n * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


def rms_norm_cut(p: Params, x: torch.Tensor, eps: float, ctx: ShardingCtx,
                 cut, d: int) -> torch.Tensor:
    """RMSNorm of rows whose last dim (``d`` wide in all) lies cut over
    the mesh axes ``cut``: x holds this rank's slice, the sum of squares
    is all-reduced over ``cut`` before the rank scales its part, and
    ``p["scale"]`` (whole) is sliced to it. Without a cut: ``apply_norm``.
    """
    if not (ctx.active and axes_of(cut)):
        return apply_norm("rmsnorm", p, x, eps)
    from repro_torch.core.collectives import all_reduce
    xf = x.to(torch.float32)
    ss = all_reduce(torch.sum(xf * xf, dim=-1, keepdim=True), ctx.mesh,
                    axes_of(cut), "norm_sumsq")
    n = xf * torch.rsqrt(ss / d + eps)
    scale = ctx.local(p["scale"], (entry_of(cut),))
    return (n * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Positions: RoPE (rotate-half split) and the sinusoidal table
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) f32 table: the sin half, then the cos half (concatenated,
    not interleaved, as the reference's)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / 10000.0 ** (dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def gated_act(kind: str, up: torch.Tensor, gate: torch.Tensor
              ) -> torch.Tensor:
    g = gate.to(torch.float32)
    if kind == "swiglu":
        return F.silu(g).to(up.dtype) * up
    if kind == "geglu":
        return F.gelu(g, approximate="tanh").to(up.dtype) * up
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def make_embedding(gen, vocab: int, d: int, dtype) -> Params:
    return {"table": dense_init(gen, (vocab, d), dtype, fan_in=d)}


def embed(p: Params, tokens: torch.Tensor, ctx: ShardingCtx = NULL_CTX,
          vocab=(), to=None) -> torch.Tensor:
    """Token embeddings. On a mesh the table holds this rank's block of
    vocabulary rows (cut over ``vocab``): tokens outside it read zeros, and
    the partial sums are reduced onto the placement ``to`` (a spec of
    (B,S,D)): a reduce-scatter onto a sharded residual, an all-reduce onto
    a replicated one."""
    if not ctx.active:
        return p["table"][tokens]
    table = p["table"]
    Vl = table.shape[0]
    rel = tokens.to(torch.long) - ctx.index(vocab) * Vl
    inb = (rel >= 0) & (rel < Vl)
    x = table[rel.clamp(0, Vl - 1)]
    x = torch.where(inb[..., None], x, torch.zeros_like(x))
    return ctx.reshard(x, (), to, partial=axes_of(vocab), site="embed")


def unembed_logits(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 logits (..., V) of x (..., D) against the (V, D) table, with f32
    accumulation of the table's exact values. The reference upcasts the
    whole table every call; here a bf16 table on the GPU goes straight into
    one bf16 x bf16 -> f32-output product (``torch.mm(..., out_dtype=
    torch.float32)``: bf16 products are exact in f32 and cuBLAS
    accumulates in f32), so no per-step f32 copy of the table exists. A
    float32 table (or the CPU) takes the plain f32 product."""
    lead, D = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, D)
    if table.dtype == torch.float32 or table.device.type != "cuda":
        out = torch.matmul(x2.to(torch.float32), table.to(torch.float32).t())
    else:
        out = torch.mm(x2.to(table.dtype), table.t(),
                       out_dtype=torch.float32)
    return out.reshape(*lead, -1)


def greedy(logits: torch.Tensor, ctx: ShardingCtx = NULL_CTX,
           vocab=()) -> torch.Tensor:
    """The greedy token (int32) of logits (..., V): ``argmax`` over the
    last dim. On a mesh the logits hold this rank's vocabulary block (cut
    over ``vocab``): each block's maximum and its global index are
    all-gathered and the first block holding the overall maximum wins, so
    ties go to the lowest index, as a whole-row argmax breaks them."""
    if not ctx.active or not axes_of(vocab):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    from repro_torch.core.collectives import all_gather
    Vl = logits.shape[-1]
    lf = logits.to(torch.float32)
    idx = torch.argmax(lf, dim=-1, keepdim=True)
    val = torch.gather(lf, -1, idx)[..., 0]
    idx = (idx[..., 0] + ctx.index(vocab) * Vl).to(torch.float32)
    both = all_gather(torch.stack([val, idx])[None], ctx.mesh,
                      axes_of(vocab), 0, "greedy")        # (n,2,...)
    win = torch.argmax(both[:, 0], dim=0, keepdim=True)
    return torch.gather(both[:, 1], 0, win)[0].to(torch.int32)


def gather_logits(logits: torch.Tensor, ctx: ShardingCtx = NULL_CTX,
                  vocab=()) -> torch.Tensor:
    """Whole-vocabulary logits on every rank (for checks and callers that
    want full rows); unchanged without a mesh."""
    if not ctx.active or not axes_of(vocab):
        return logits
    from repro_torch.core.collectives import all_gather
    return all_gather(logits, ctx.mesh, axes_of(vocab), logits.ndim - 1,
                      "gather_logits")


# ---------------------------------------------------------------------------
# Training: rematerialisation and the chunked cross-entropy loss
# ---------------------------------------------------------------------------

def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    instead of kept (the reference's ``jax.checkpoint(...,
    nothing_saveable)`` around each block). Without autograd (serving,
    ``torch.no_grad``) it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def ce_chunk(S: int, target: int = 512) -> int:
    """Largest divisor of S that is <= target (vision-token offsets make S
    no power of two)."""
    for c in range(min(target, S), 0, -1):
        if S % c == 0:
            return c
    return S


def _ce_sum(table: torch.Tensor, xc: torch.Tensor, lc: torch.Tensor,
            ctx: ShardingCtx = NULL_CTX, vocab=(), weight=None
            ) -> torch.Tensor:
    """Sum over one chunk of lse - gold: the (B,c,V) logits in f32 of the
    f32 images of x and the table, as the reference's einsum. ``weight``
    (on a mesh) gathers the table's fsdp shards first, here inside the
    chunk's ``remat``, so the recompute gathers again.

    On a mesh whose rules cut the vocabulary over ``vocab``, the table
    holds this rank's block of rows: the row maximum is all-reduced (max;
    it carries no gradient), and the sums of exponentials and the gold
    logits (each from the rank whose block holds the label, 0 elsewhere)
    are summed over ``vocab`` by ``reduce_from``: every rank then holds
    the chunk's whole loss, and each rank's logits get the gradient of
    it once."""
    from repro_torch.core import collectives as C
    if weight is not None:
        table = weight(table)
    logits = torch.einsum("bcd,vd->bcv", xc.to(torch.float32),
                          table.to(torch.float32))
    # the shift only steadies the exponent: it has no gradient (the
    # reference's flows through max and cancels exactly)
    m = torch.amax(logits, dim=-1).detach()
    split = ctx.active and axes_of(vocab)
    if split:
        m = C.all_reduce(m, ctx.mesh, axes_of(vocab), "ce_max", op="max")
        Vl = table.shape[0]
        rel = lc.to(torch.long) - ctx.index(vocab) * Vl
        inb = (rel >= 0) & (rel < Vl)
        gold = torch.gather(logits, -1, rel.clamp(0, Vl - 1)[..., None])
        gold = torch.where(inb, gold[..., 0], torch.zeros_like(gold[..., 0]))
    else:
        gold = torch.gather(logits, -1, lc.to(torch.long)[..., None])[..., 0]
    se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    if split:
        se, gold = C.reduce_from(torch.stack([se, gold]), ctx.mesh,
                                 axes_of(vocab), "ce_stats")
    return torch.sum(m + torch.log(se) - gold)


def lm_loss(params, key, x: torch.Tensor, labels: torch.Tensor, lay
            ) -> torch.Tensor:
    """``chunked_ce_loss`` of x against the (V, D) table at
    ``params[key[0]][key[1]]`` (the embedding, or an untied unembedding)
    on the training layout ``lay`` (a ``MeshLayout``): vocabulary-parallel
    over ``lay.vocab``, the table's fsdp shards gathered inside each
    chunk's ``remat``."""
    return chunked_ce_loss(
        params[key[0]][key[1]], x, labels, lay.ctx,
        chunk=ce_chunk(x.shape[1]), vocab=lay.vocab,
        weight=(lambda t: lay.weight(t, key)) if lay.fsdp else None)


def chunked_ce_loss(table: torch.Tensor, x: torch.Tensor,
                    labels: torch.Tensor, ctx: ShardingCtx = NULL_CTX,
                    chunk: int = 512, vocab=(), weight=None
                    ) -> torch.Tensor:
    """Mean cross-entropy of x (B,S,D) against the (V,D) table, WITHOUT a
    (B,S,V) logits tensor: the sequence goes in chunks of ``chunk``
    positions; each chunk's (B,c,V) f32 logits are reduced to the sum of
    lse - gold and dropped (and recomputed, under autograd, in the
    backward: ``remat``). The sums are added in chunk order in f32 and
    divided by B*S, as the reference's scan does.

    On a mesh (``ctx``) x holds this rank's rows of the global batch,
    whole over the other axes, and the table this rank's vocabulary rows
    (cut over ``vocab``; ``_ce_sum``); the result is this rank's share of
    the global mean: its rows' sum over the GLOBAL count of positions, so
    the shares summed over the batch axes give the reference's loss.
    Where the rules leave the vocabulary whole, the ranks that would
    compute the same chunks take every n-th chunk and ``reduce_from`` sums
    them, so each chunk's loss counts once."""
    from repro_torch.core import collectives as C
    B, S, _ = x.shape
    n = S // chunk
    if n * chunk != S:
        raise ValueError(f"chunked_ce_loss: chunk {chunk} does not divide "
                         f"the sequence {S} (ce_chunk(S) does)")
    rows, rep = B, ()
    if ctx.active:
        rows = B * ctx.n(entry_of(ctx.batch_axes))
        rep = tuple(a for a in ctx.mesh.axis_names
                    if a not in ctx.batch_axes and a not in axes_of(vocab)
                    and ctx.mesh.shape[a] > 1)
    n_rep, me = (ctx.n(entry_of(rep)), ctx.index(entry_of(rep))) if rep \
        else (1, 0)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(me, n, n_rep):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + remat(_ce_sum, table, x[:, sl], labels[:, sl], ctx,
                              vocab, weight)
    if rep:
        total = C.reduce_from(total, ctx.mesh, rep, "ce_chunks")
    return total / (rows * S)
