"""Recurrent decode state of the attention-free blocks (RG-LRU, Mamba-2
SSD): the port of ``repro.kv.state``.

Unlike a KV cache the state is O(1) in the context. It is kept in f32.
As with ``kv/cache.py`` the slot operations work IN PLACE on the tensors
they are given and return them: admission copies one row, retirement
zeroes one, and ``mask_slots`` writes a decode step's new state only into
the active rows, so an inactive row keeps its bytes.

On a mesh a rank holds its data row's slots and its heads' part of the
state. The RG-LRU's state and conv window are cut over ``lru`` as the
reference's ``cache_specs`` cuts them. The SSD's conv window holds the
``xs`` channels, then the ``bc`` channels (``d_inner + 2N`` in all); the
reference cuts that last dim evenly over ``lru``, which does not line up
with the heads a rank owns, so here a rank holds its heads' ``xs``
channels followed by the whole ``bc``: ``ssd_state_local`` cuts a whole
state into that layout and ``ssd_state_gather`` puts the whole state back
together on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class RecurrentState:
    h: torch.Tensor          # RG-LRU: (L,B,lru) f32 | SSD: (L,B,nh,hd,N) f32
    conv: torch.Tensor       # rolling conv window (L,B,W-1,C) f32


def init_rglru_state(n_layers: int, batch: int, lru_width: int,
                     conv_width: int, device=None) -> RecurrentState:
    return RecurrentState(
        h=torch.zeros((n_layers, batch, lru_width), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((n_layers, batch, conv_width - 1, lru_width),
                         dtype=torch.float32, device=device))


def init_ssd_state(n_layers: int, batch: int, n_heads: int, head_dim: int,
                   d_state: int, conv_width: int, conv_channels: int,
                   device=None) -> RecurrentState:
    return RecurrentState(
        h=torch.zeros((n_layers, batch, n_heads, head_dim, d_state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((n_layers, batch, conv_width - 1, conv_channels),
                         dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# Per-slot (continuous-batching) operations, in place. ``state`` is a
# RecurrentState (or None); every leaf has its batch axis at 1.
# ---------------------------------------------------------------------------

def _leaves(state: RecurrentState):
    return (state.h, state.conv)


def write_slot_tree(dst: RecurrentState, src: RecurrentState, slot: int,
                    batch_axis: int = 1) -> RecurrentState:
    """Admission: copy the batch-1 state ``src`` into batch row ``slot`` of
    every leaf of ``dst``."""
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.select(batch_axis, slot).copy_(s.select(batch_axis, 0))
    return dst


def reset_slot_tree(state: RecurrentState, slot: int,
                    batch_axis: int = 1) -> RecurrentState:
    """Zero one batch row of every leaf (retire a finished request)."""
    for a in _leaves(state):
        a.select(batch_axis, slot).zero_()
    return state


def mask_rows(active: Optional[torch.Tensor], new: torch.Tensor,
              old: torch.Tensor, batch_axis: int = 1) -> torch.Tensor:
    """``old`` takes the rows of ``new`` (along ``batch_axis``) where
    ``active`` (B,) is set; the other rows of ``old`` are not written. On
    the device with no host sync: inactive rows are redirected to the
    first active row's index, and every index carries its own row's new
    value, so the duplicate writes agree. With no row active every index
    is row 0 and row 0 gets its own old bytes back. ``active`` None: every
    row. Returns ``old``."""
    if active is None:
        return old.copy_(new)
    B = new.shape[batch_axis]
    first = torch.argmax(active.to(torch.int32))
    idx = torch.where(active, torch.arange(B, device=active.device), first)
    src = new.index_select(batch_axis, idx).to(old.dtype)
    src = torch.where(active.any(), src, old.narrow(batch_axis, 0, 1))
    return old.index_copy_(batch_axis, idx, src)


def mask_slots(active: torch.Tensor, new: RecurrentState,
               old: RecurrentState, batch_axis: int = 1) -> RecurrentState:
    """Active-slot masking of a recurrent decode step: every leaf of
    ``old`` takes the rows of ``new`` where ``active`` (B,) is set, and the
    inactive rows keep their bytes without being written (``mask_rows``).
    Returns ``old``."""
    for n, o in zip(_leaves(new), _leaves(old)):
        mask_rows(active, n, o, batch_axis)
    return old


def conv_step(conv_state: torch.Tensor, x_new: torch.Tensor,
              conv_w: torch.Tensor, conv_b: Optional[torch.Tensor] = None):
    """Causal depthwise conv, one step. conv_state: (B,W-1,C); x_new: (B,C);
    conv_w: (W,C). Returns (y (B,C) in x_new's dtype, new window (B,W-1,C)
    in the state's dtype)."""
    window = torch.cat([conv_state, x_new[:, None, :].to(conv_state.dtype)],
                       dim=1)                                    # (B,W,C)
    y = torch.einsum("bwc,wc->bc", window, conv_w.to(window.dtype))
    if conv_b is not None:
        y = y + conv_b
    return y.to(x_new.dtype), window[:, 1:, :]


def causal_conv(x: torch.Tensor, conv_w: torch.Tensor,
                conv_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv over a sequence. x: (B,S,C); conv_w: (W,C).
    Starts from zeros and adds w = 0..W-1 in order, in x's dtype, as the
    reference does: a chunk whose window starts at zeros is bit-identical
    to this."""
    W = conv_w.shape[0]
    pad = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    y = torch.zeros_like(x)
    for w in range(W):
        y = y + pad[:, w:w + x.shape[1], :] * conv_w[w][None, None, :].to(
            x.dtype)
    if conv_b is not None:
        y = y + conv_b.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# On a mesh: a whole state cut into this rank's part, and gathered back
# ---------------------------------------------------------------------------

def _rows_entry(ctx):
    from repro_torch.models.sharding import entry_of
    return entry_of(ctx.batch_axes)


def ssd_state_local(state: RecurrentState, ctx, d_inner: int,
                    cut) -> RecurrentState:
    """This rank's part of a whole SSD state: its data row's slots, its
    heads' H (heads cut over the axes ``cut``) and a conv window of its
    heads' ``xs`` channels followed by every ``bc`` channel."""
    from repro_torch.models.sharding import entry_of
    rows, c = _rows_entry(ctx), entry_of(tuple(cut))
    h = ctx.local(state.h, (None, rows, c))
    conv = ctx.local(state.conv, (None, rows))
    xs = ctx.local(conv[..., :d_inner], (None, None, None, c))
    return RecurrentState(h=h.contiguous(), conv=torch.cat(
        [xs, conv[..., d_inner:]], dim=-1).contiguous())


def ssd_state_gather(state: RecurrentState, ctx, d_inner: int,
                     cut) -> RecurrentState:
    """The whole SSD state on every rank from each rank's part
    (``ssd_state_local``'s layout): collective over the mesh."""
    from repro_torch.core.collectives import all_gather
    from repro_torch.models.sharding import axes_of, entry_of
    cut, rows = tuple(cut), axes_of(_rows_entry(ctx))
    h, conv = state.h, state.conv
    n = ctx.n(entry_of(cut))
    if cut:
        h = all_gather(h, ctx.mesh, cut, 2, "state_gather")
        xs = all_gather(conv[..., :d_inner // n], ctx.mesh, cut, 3,
                        "state_gather")
        conv = torch.cat([xs, conv[..., d_inner // n:]], dim=-1)
    if rows:
        h = all_gather(h, ctx.mesh, rows, 1, "state_gather")
        conv = all_gather(conv, ctx.mesh, rows, 1, "state_gather")
    return RecurrentState(h=h, conv=conv)


def rglru_state_gather(state: RecurrentState, ctx, cut) -> RecurrentState:
    """The whole RG-LRU state on every rank (collective over the mesh)."""
    from repro_torch.core.collectives import all_gather
    from repro_torch.models.sharding import axes_of
    cut, rows = tuple(cut), axes_of(_rows_entry(ctx))
    h, conv = state.h, state.conv
    if cut:
        h = all_gather(h, ctx.mesh, cut, 2, "state_gather")
        conv = all_gather(conv, ctx.mesh, cut, 3, "state_gather")
    if rows:
        h = all_gather(h, ctx.mesh, rows, 1, "state_gather")
        conv = all_gather(conv, ctx.mesh, rows, 1, "state_gather")
    return RecurrentState(h=h, conv=conv)
