"""Mamba-2 (SSD, state-space duality) blocks: the port of
``repro.models.ssm`` (inference, and the training forward and loss).

Attention-free: the decode state is O(1) in the context. Prefill runs the
chunked SSD algorithm (the quadratic form inside a chunk, a scan of the
chunk boundary states between chunks); decode is the exact one-step
recurrence

    H_t = a_t H_{t-1} + dt_t (x_t outer B_t),   y_t = H_t C_t + D x_t
    a_t = exp(-exp(A_log) dt_t),  dt_t = softplus(dt_raw + dt_bias)

There is no TPU kernel on this path in the reference (its projections are
einsums outside any Pallas kernel), so everything here is plain PyTorch in
the reference's dtypes: the state and the conv window in f32, ``y`` cast
to the compute dtype before the gated RMSNorm. The state is updated IN
PLACE (``kv/state.py``); ``jnp.repeat(..., axis)`` is ``repeat_interleave``.

On a mesh (``ctx``) the heads are independent and cut over ``model``
(``ssm_heads``, and their channels as ``lru``): a rank projects its heads'
``z``, ``xs`` and ``dt`` columns, holds their ``dt_bias``, ``A_log``,
``D_skip`` and conv taps, and the whole ``bc`` (one group, replicated);
the gated RMSNorm over all of ``d_inner`` all-reduces the sum of squares
before the rank scales its part; ``out_proj`` is row-parallel onto the
residual's placement (all-reduce under operator_centric, reduce-scatter
under sub_operator). The rank's state holds its heads' H and a conv
window of its ``xs`` channels followed by the whole ``bc``
(``kv/state.py::ssd_state_local``). The batch rows are the caller's
(its data row's), the logits this rank's vocabulary rows.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kv.state import (RecurrentState, causal_conv, conv_step,
                                  init_ssd_state, mask_rows)
from repro_torch.models import common
from repro_torch.models.sharding import (NULL_CTX, NULL_LAYOUT, MeshLayout,
                                         ShardingCtx, channel_head_cut,
                                         entry_of, layout)
from repro_torch.models.transformer import final_logits, row_linear

PAD_DT = -1e4           # softplus(PAD_DT + bias) == 0: a padded step is a no-op


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    return d_in, nh, s.head_dim, s.d_state, s.n_groups, s.conv_width


def mesh_cut(cfg: ModelConfig, ctx: ShardingCtx) -> Tuple[str, ...]:
    """The mesh axes this rank's heads (and their inner channels) are cut
    over: () on one device or where the rules leave them whole."""
    d_in, nh = dims(cfg)[:2]
    return channel_head_cut(ctx, "SSD", cfg.d_model, d_in, "ssm_heads", nh)


def _local(p):
    """(inner channels, heads) of this rank's SSD parameters."""
    return p["conv_x"].shape[1], p["A_log"].shape[0]


def make_ssd_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    d_in, nh, hd, N, G, W = dims(cfg)
    dt = common.dtype_of(cfg)
    dev = gen.device
    return {
        "z_proj": common.make_linear(gen, d, d_in, dt),
        "x_proj": common.make_linear(gen, d, d_in, dt),
        "bc_proj": common.make_linear(gen, d, 2 * G * N, dt),
        "dt_proj": common.make_linear(gen, d, nh, dt),
        "dt_bias": torch.full((nh,), -3.0, dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=dev)),
        "D_skip": torch.ones((nh,), dtype=torch.float32, device=dev),
        "conv_x": common.dense_init(gen, (W, d_in), dt, fan_in=W),
        "conv_bc": common.dense_init(gen, (W, 2 * G * N), dt, fan_in=W),
        "norm": common.make_norm("rmsnorm", d_in, dt, dev),
        "out_proj": common.make_linear(gen, d_in, d, dt),
    }


def _project(p, x):
    """The shared projections. x: (B,S,D) -> z, xs (B,S,d_in), bc
    (B,S,2GN) in the compute dtype and dt_raw (B,S,nh) f32, before the
    conv and the activations."""
    z, xs, bc, dt_raw = common.linears(
        [p["z_proj"], p["x_proj"], p["bc_proj"], p["dt_proj"]], x)
    return z, xs, bc, dt_raw.to(torch.float32)


def _rep(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(t, n, axis=dim)``: each element n times in a row."""
    return t if n == 1 else t.repeat_interleave(n, dim=dim)


def _gated_out(p, y, z, x_dtype, cfg, lay: MeshLayout = NULL_LAYOUT,
               cut=()):
    """y (f32, (B,S,d_in)) cast to the compute dtype, the gated RMSNorm
    (silu(z) rounded to the compute dtype) and the output projection. On
    a mesh y holds the rank's channels: the norm's sum of squares is
    all-reduced over ``cut`` and ``out_proj`` is row-parallel onto the
    residual's placement."""
    y = common.rms_norm_cut(p["norm"], y.to(x_dtype), cfg.norm_eps,
                            lay.ctx, cut, dims(cfg)[0])
    y = y * F.silu(z.to(torch.float32)).to(y.dtype)
    return row_linear(p["out_proj"], y, lay, cut, "ssd_out")


def ssd_full_seq(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 lay: MeshLayout = NULL_LAYOUT, cut=()) -> torch.Tensor:
    """Chunked SSD over a full sequence. x: (B,S,D) -> (B,S,D) (on a mesh:
    x whole, the output on the residual's placement)."""
    _, _, hd, N, G, W = dims(cfg)
    d_in, nh = _local(p)
    B, S0, _ = x.shape
    Q = min(cfg.ssm.chunk, S0)
    S = -(-S0 // Q) * Q                                   # pad to chunk multiple
    nc = S // Q
    f32 = torch.float32

    z, xs, bc, dt_raw = _project(p, x)
    if S != S0:
        xs = F.pad(xs, (0, 0, 0, S - S0))
        bc = F.pad(bc, (0, 0, 0, S - S0))
        # padded steps: dt -> 0, so a = 1 and no contribution (exact no-op)
        dt_raw = F.pad(dt_raw, (0, 0, 0, S - S0), value=PAD_DT)
    xs = F.silu(causal_conv(xs, p["conv_x"]).to(f32))
    bc = F.silu(causal_conv(bc, p["conv_bc"]).to(f32))
    Bm, Cm = torch.split(bc, G * N, dim=-1)               # (B,S,G*N)
    Bm = Bm.reshape(B, nc, Q, G, N)
    Cm = Cm.reshape(B, nc, Q, G, N)
    xh = xs.reshape(B, nc, Q, nh, hd)

    dt = F.softplus(dt_raw + p["dt_bias"])                # (B,S,nh) f32
    A = -torch.exp(p["A_log"])                            # (nh,)
    loga = (dt * A).reshape(B, nc, Q, nh)                 # log decay per step
    L = torch.cumsum(loga, dim=2)                         # (B,nc,Q,nh)
    dtc = dt.reshape(B, nc, Q, nh)

    # intra-chunk: M[t,s] = C_t.B_s exp(L_t - L_s) dt_s  (s <= t)
    CB = torch.einsum("bcqgn,bcsgn->bcgqs", Cm, Bm)       # (B,nc,G,Q,Q)
    CBh = _rep(CB, nh // G, 2)                            # (B,nc,nh,Q,Q)
    Lt = L.permute(0, 1, 3, 2)                            # (B,nc,nh,Q)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # the exponent masked BEFORE exp: above the diagonal L_t - L_s > 0 can
    # overflow to inf, and inf x the masked zero gradient is a NaN in the
    # backward (the reference masks after exp; its forward values are these)
    decay = torch.exp(torch.where(tri, Lt[..., :, None] - Lt[..., None, :],
                                  torch.full((), -math.inf,
                                             device=x.device)))
    M = torch.where(tri, CBh * decay, torch.zeros((), device=x.device))
    M = M * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", M, xh)

    # chunk boundary states: H_c = sum_s exp(L_end - L_s) dt_s (x_s outer B_s)
    w = torch.exp(L[:, :, -1:, :] - L) * dtc              # (B,nc,Q,nh)
    Bh = _rep(Bm, nh // G, 3)                             # (B,nc,Q,nh,N)
    H_part = torch.einsum("bcqh,bcqhp,bcqhn->bchpn", w, xh, Bh)

    # inter-chunk scan: the state BEFORE each chunk
    A_chunk = torch.exp(L[:, :, -1, :])                   # (B,nc,nh)
    H = torch.zeros((B, nh, hd, N), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(H)
        H = H * A_chunk[:, c, :, None, None] + H_part[:, c]
    H_prev = torch.stack(prev, dim=1)                     # (B,nc,nh,hd,N)

    Ch = _rep(Cm, nh // G, 3)                             # (B,nc,Q,nh,N)
    y_inter = torch.einsum("bcqh,bcqhn,bchpn->bcqhp", torch.exp(L), Ch,
                           H_prev)
    y = y_intra + y_inter + p["D_skip"][:, None] * xh
    y = y.reshape(B, S, d_in)[:, :S0]
    return _gated_out(p, y, z, x.dtype, cfg, lay, cut)


def ssd_final_state(p: Dict, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state after consuming x (the prefill-to-decode handoff):
    (H (B,nh,hd,N) f32, conv window (B,W-1,channels) f32), over this
    rank's heads and channels on a mesh."""
    _, _, hd, N, G, W = dims(cfg)
    d_in, nh = _local(p)
    B, S, _ = x.shape
    f32 = torch.float32
    _, xs, bc, dt_raw = _project(p, x)
    conv_tail = torch.cat([xs, bc], dim=-1)[:, -(W - 1):, :].to(f32)
    xs = F.silu(causal_conv(xs, p["conv_x"]).to(f32))
    bc = F.silu(causal_conv(bc, p["conv_bc"]).to(f32))
    Bm = bc[..., :G * N].reshape(B, S, G, N)
    dt = F.softplus(dt_raw + p["dt_bias"])
    loga = dt * -torch.exp(p["A_log"])                    # (B,S,nh)
    Lrev = torch.flip(torch.cumsum(torch.flip(loga, [1]), dim=1), [1])
    dec = torch.exp(Lrev - loga)                          # exp(sum_{u>s})
    xh = xs.reshape(B, S, nh, hd)
    Bh = _rep(Bm, nh // G, 2)                             # (B,S,nh,N)
    H = torch.einsum("bsh,bshp,bshn->bhpn", dec * dt, xh, Bh)
    return H, conv_tail


def ssd_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig, H: torch.Tensor,
               conv: torch.Tensor, lay: MeshLayout = NULL_LAYOUT, cut=()
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step over one layer's state. x: (B,1,D); H: (B,nh,hd,N);
    conv: (B,W-1,Ch) -> (out (B,1,D), H', conv') with the new state in
    fresh f32 tensors."""
    _, _, hd, N, G, W = dims(cfg)
    d_in, nh = _local(p)
    B = x.shape[0]
    f32 = torch.float32
    z, xs, bc, dt_raw = _project(p, x)
    xbc_new = torch.cat([xs[:, 0], bc[:, 0]], dim=-1)
    conv_w = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1)
    y_conv, conv_new = conv_step(conv, xbc_new, conv_w)
    xs1 = F.silu(y_conv[:, :d_in].to(f32))
    bc1 = F.silu(y_conv[:, d_in:].to(f32))
    Bm = bc1[:, :G * N].reshape(B, G, N)
    Cm = bc1[:, G * N:].reshape(B, G, N)
    dt = F.softplus(dt_raw[:, 0] + p["dt_bias"])          # (B,nh)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)            # (B,nh)
    xh = xs1.reshape(B, nh, hd)
    Bh = _rep(Bm, nh // G, 1)                             # (B,nh,N)
    Ch = _rep(Cm, nh // G, 1)
    H = H * a[..., None, None] + torch.einsum("bh,bhp,bhn->bhpn", dt, xh,
                                              Bh)
    y = torch.einsum("bhpn,bhn->bhp", H, Ch) + p["D_skip"][None, :, None] * xh
    out = _gated_out(p, y.reshape(B, 1, d_in), z, x.dtype, cfg, lay, cut)
    return out, H, conv_new.to(f32)


def ssd_chunk(p: Dict, x: torch.Tensor, cfg: ModelConfig, H0: torch.Tensor,
              conv0: torch.Tensor, valid_len: int,
              lay: MeshLayout = NULL_LAYOUT, cut=()
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prompt chunk of the SSD recurrence with carried state (the
    chunked-prefill lane): the quadratic form of ``ssd_full_seq`` over one
    chunk plus the contribution of the incoming state ``H0`` and conv
    window ``conv0``. x: (1,C,D); H0: (1,nh,hd,N); conv0: (1,W-1,Ch);
    ``valid_len`` a host int: chunk positions at or past it are padding and
    exact no-ops on the state. Returns (y (1,C,D), H_end, conv_end), the
    window ending at the last REAL input."""
    _, _, hd, N, G, W = dims(cfg)
    d_in, nh = _local(p)
    B, C, _ = x.shape
    f32 = torch.float32
    z, xs, bc, dt_raw = _project(p, x)
    valid = torch.arange(C, device=x.device) < valid_len
    dt_raw = torch.where(valid[None, :, None], dt_raw,
                         torch.full((), PAD_DT, device=x.device))
    # the rolling causal conv across chunk boundaries, in causal_conv's
    # dtype and order: a first chunk (conv0 == 0) is bit-identical to it
    xbc = torch.cat([xs, bc], dim=-1)                     # (1,C,Ch)
    full = torch.cat([conv0.to(xbc.dtype), xbc], dim=1)   # (1,W-1+C,Ch)
    conv_w = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1)
    y_conv = torch.zeros_like(xbc)
    for w in range(W):
        y_conv = y_conv + full[:, w:w + C, :] * conv_w[w][None, None, :].to(
            xbc.dtype)
    conv_end = full[:, valid_len:valid_len + W - 1, :].to(f32)
    xs1 = F.silu(y_conv[..., :d_in].to(f32))
    bc1 = F.silu(y_conv[..., d_in:].to(f32))
    Bm = bc1[..., :G * N].reshape(B, C, G, N)
    Cm = bc1[..., G * N:].reshape(B, C, G, N)
    xh = xs1.reshape(B, C, nh, hd)

    dt = F.softplus(dt_raw + p["dt_bias"])                # (B,C,nh) f32
    L = torch.cumsum(dt * -torch.exp(p["A_log"]), dim=1)  # (B,C,nh)

    CB = torch.einsum("bqgn,bsgn->bgqs", Cm, Bm)          # (B,G,C,C)
    CBh = _rep(CB, nh // G, 1)                            # (B,nh,C,C)
    Lt = L.permute(0, 2, 1)                               # (B,nh,C)
    decay = torch.exp(Lt[:, :, :, None] - Lt[:, :, None, :])
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))
    M = torch.where(tri, CBh * decay, torch.zeros((), device=x.device))
    M = M * dt.permute(0, 2, 1)[:, :, None, :]
    y_intra = torch.einsum("bhqs,bshp->bqhp", M, xh)

    Ch = _rep(Cm, nh // G, 2)                             # (B,C,nh,N)
    H0 = H0.to(f32)
    y_inter = torch.einsum("bqh,bqhn,bhpn->bqhp", torch.exp(L), Ch, H0)

    dec_end = torch.exp(L[:, -1:, :] - L)                 # (B,C,nh)
    Bh = _rep(Bm, nh // G, 2)                             # (B,C,nh,N)
    H_end = H0 * torch.exp(L[:, -1, :])[..., None, None] \
        + torch.einsum("bsh,bshp,bshn->bhpn", dec_end * dt, xh, Bh)

    y = y_intra + y_inter + p["D_skip"][None, None, :, None] * xh
    out = _gated_out(p, y.reshape(B, C, d_in), z, x.dtype, cfg, lay, cut)
    return out, H_end, conv_end


# ---------------------------------------------------------------------------
# Whole model: SSD blocks (norm, mix, residual) and the final norm; no FFN
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Seeded random parameters on ``gen.device``; ``blocks`` is a list of
    per-layer dicts."""
    dt = common.dtype_of(cfg)
    dev = gen.device
    return {
        "embed": common.make_embedding(gen, cfg.vocab_size, cfg.d_model, dt),
        "blocks": [{"ln": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
                    "ssd": make_ssd_params(gen, cfg)}
                   for _ in range(cfg.n_layers)],
        "ln_f": common.make_norm(cfg.norm, cfg.d_model, dt, dev),
    }


def forward_train(params, tokens: torch.Tensor, cfg: ModelConfig,
                  ctx: ShardingCtx = NULL_CTX, lay=None) -> torch.Tensor:
    """Training forward (the reference's ``forward_hidden(train=True)``):
    every block (norm, SSD, residual) under ``remat``; the hidden (B,S,D)
    after the final norm. On a mesh (``ctx``; ``lay`` its training
    layout) tokens are this rank's rows, each block gathers its fsdp
    shards inside the ``remat`` and runs the mesh prefill's sites (the
    heads over the model axis, the gated norm's sum of squares
    all-reduced, ``out_proj`` row-parallel onto the residual), and the
    hidden state is whole over the other axes."""
    lay = layout(cfg, ctx, train=True) if lay is None else lay
    cut = mesh_cut(cfg, ctx)

    def block(lp, h):
        lp = lay.weights(lp)
        return h + ssd_full_seq(lp["ssd"], _norm_in(lp, h, cfg, lay), cfg,
                                lay, cut)

    h = _embed(lay.weights({"embed": params["embed"]}, "top"), tokens, lay)
    for lp in params["blocks"]:
        h = common.remat(block, lp, h)
    h = lay.to_full(h, "ln_f_in")
    return common.apply_norm(cfg.norm, params["ln_f"], h, cfg.norm_eps)


def loss_fn(params, batch, cfg: ModelConfig, ctx: ShardingCtx = NULL_CTX
            ) -> torch.Tensor:
    """Chunked cross-entropy against the embedding table (no aux term).
    On a mesh: this rank's share of the loss (summed over the batch axes
    it is the reference's), vocabulary-parallel over the table's rows,
    which fsdp gathers inside each chunk's ``remat``."""
    lay = layout(cfg, ctx, train=True)
    x = forward_train(params, batch["tokens"], cfg, ctx, lay)
    return common.lm_loss(params, ("embed", "table"), x, batch["labels"],
                          lay)


def _mesh(cfg: ModelConfig, ctx: ShardingCtx):
    return layout(cfg, ctx), mesh_cut(cfg, ctx)


def _embed(params, tokens, lay: MeshLayout):
    return common.embed(params["embed"], tokens, lay.ctx, lay.vocab,
                        lay.res_spec())


def _norm_in(lp, h, cfg, lay: MeshLayout):
    """The block's norm of the whole residual (gathered on a mesh)."""
    return common.apply_norm(cfg.norm, lp["ln"], lay.to_full(h, "ln_in"),
                             cfg.norm_eps)


def make_state(cfg: ModelConfig, batch: int, device=None,
               ctx: ShardingCtx = NULL_CTX) -> RecurrentState:
    """A zeroed state of ``batch`` slots; on a mesh this rank's part
    (its data row's slots, its heads, its conv layout)."""
    d_in, nh, hd, N, G, W = dims(cfg)
    if ctx.active:
        rows = ctx.n(ctx.batch_axes)
        n = ctx.n(entry_of(mesh_cut(cfg, ctx)))
        batch, nh, d_in = batch // rows, nh // n, d_in // n
    return init_ssd_state(cfg.n_layers, batch, nh, hd, N, W,
                          conv_channels=d_in + 2 * G * N, device=device)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: ShardingCtx = NULL_CTX
            ) -> Tuple[RecurrentState, torch.Tensor]:
    """Encode the prompt (B,S): (state, last-position logits (B,1,V))."""
    lay, cut = _mesh(cfg, ctx)
    h = _embed(params, tokens, lay)
    Hs, convs = [], []
    for lp in params["blocks"]:
        y = _norm_in(lp, h, cfg, lay)
        H, conv = ssd_final_state(lp["ssd"], y, cfg)
        Hs.append(H)
        convs.append(conv)
        h = h + ssd_full_seq(lp["ssd"], y, cfg, lay, cut)
    state = RecurrentState(h=torch.stack(Hs), conv=torch.stack(convs))
    return state, final_logits(params, h[:, -1:], cfg, lay)


def decode_step_slotted(params, state: RecurrentState, tokens: torch.Tensor,
                        positions: Optional[torch.Tensor],
                        active: Optional[torch.Tensor], cfg: ModelConfig,
                        kv_bucket: int = 0, kv_shards: int = 1,
                        ctx: ShardingCtx = NULL_CTX
                        ) -> Tuple[RecurrentState, torch.Tensor]:
    """Continuous-batching decode step. The recurrence does not depend on
    the position, so the cursors only say which rows commit: each layer's
    new (H, conv) is written into the state in place for the ``active``
    rows only (``mask_rows``); inactive rows keep their bytes unwritten.
    ``active`` None: every row (the drain step). ``kv_bucket`` and
    ``kv_shards`` are accepted for the KV families' signature and ignored.
    Returns (state, logits (B,1,V) f32). No host sync."""
    del positions, kv_bucket, kv_shards
    lay, cut = _mesh(cfg, ctx)
    h = _embed(params, tokens[:, None], lay)
    for i, lp in enumerate(params["blocks"]):
        y = _norm_in(lp, h, cfg, lay)
        o, H, conv = ssd_decode(lp["ssd"], y, cfg, state.h[i],
                                state.conv[i], lay, cut)
        mask_rows(active, H, state.h[i], 0)
        mask_rows(active, conv, state.conv[i], 0)
        h = h + o
    return state, final_logits(params, h, cfg, lay)


def decode_step(params, state: RecurrentState, tokens: torch.Tensor,
                cfg: ModelConfig, ctx: ShardingCtx = NULL_CTX
                ) -> Tuple[RecurrentState, torch.Tensor]:
    """Shared-cursor decode step (drain serving): every row advances."""
    return decode_step_slotted(params, state, tokens, None, None, cfg,
                               ctx=ctx)


def prefill_chunk(params, state: RecurrentState, tokens: torch.Tensor,
                  slot: int, start: int, valid_len: int, cfg: ModelConfig,
                  ctx: ShardingCtx = NULL_CTX
                  ) -> Tuple[RecurrentState, torch.Tensor]:
    """Chunked prefill: one (1,C) chunk of slot ``slot``'s prompt advances
    its per-layer (H, conv window) through ``ssd_chunk``. ``start`` == 0
    starts from a zero state (a freed slot may hold its previous occupant's
    state). ``slot``, ``start`` and ``valid_len`` are host ints (on a mesh
    ``slot`` is this data row's local slot). Returns (state, logits
    (1,1,V)) at the last valid position."""
    lay, cut = _mesh(cfg, ctx)
    h = _embed(params, tokens, lay)
    for i, lp in enumerate(params["blocks"]):
        H_all, conv_all = state.h[i], state.conv[i]
        H0, conv0 = H_all[slot:slot + 1], conv_all[slot:slot + 1]
        if start == 0:
            H0, conv0 = torch.zeros_like(H0), torch.zeros_like(conv0)
        y = _norm_in(lp, h, cfg, lay)
        o, H1, conv1 = ssd_chunk(lp["ssd"], y, cfg, H0, conv0, valid_len,
                                 lay, cut)
        H_all[slot].copy_(H1[0])
        conv_all[slot].copy_(conv1[0])
        h = h + o
    return state, final_logits(params, h[:, valid_len - 1:valid_len], cfg,
                               lay)
