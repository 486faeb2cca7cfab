"""Partial-softmax merge of flash decode statistics, the port of
``repro.kernels.flash_decode.combine``.

A split of the KV walk reports un-normalised statistics: ``o`` (the
weighted value sum), ``m`` (the running max of its masked scores) and
``l`` (the normaliser). ``merge_partial_stats`` folds them with the LSE
merge

    M = max_s m_s;   a_s = exp(m_s - M);   l = sum_s l_s a_s;
    o = sum_s o_s a_s

and ``combine_partial_stats`` then normalises by ``max(l, 1e-30)``. The
"no scores yet" sentinel is the finite ``NEG_INF = -1e30``, so a split
that was skipped whole (the identity ``(0, NEG_INF, 0)``) merges exactly.
This is the plain form of the merge that K1's last CTA runs across its
splits of S (``csrc/flash_decode.cu``); everything is float32.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
_EPS = 1e-30


def merge_partial_stats(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                        axis: int = 0):
    """``m``/``l`` share a shape; ``o`` has one more trailing dim (hd).
    ``axis`` (non-negative) is the split axis of ``m``. Returns the
    un-normalised ``(o, m, l)`` with that axis reduced."""
    o, m, l = (t.to(torch.float32) for t in (o, m, l))
    m_star = torch.amax(m, dim=axis, keepdim=True)
    alpha = torch.exp(m - m_star)                # <= 1; empty splits -> 0
    l_star = torch.sum(l * alpha, dim=axis)
    o_star = torch.sum(o * alpha.unsqueeze(-1), dim=axis)
    return o_star, m_star.squeeze(axis), l_star


def combine_partial_stats(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                          axis: int = 0) -> torch.Tensor:
    """Merge and normalise: ``o / max(l, 1e-30)`` in float32, equal to the
    sequential walk over the concatenated splits."""
    o_star, _, l_star = merge_partial_stats(o, m, l, axis=axis)
    return o_star / torch.clamp_min(l_star, _EPS).unsqueeze(-1)
