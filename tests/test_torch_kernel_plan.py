"""Launch plans of the K1, K3 and K4 CUDA kernels, checked on the CPU.

The host side of each wrapper picks the grid, the split of the reduction
axis and the scratch size in plain Python (``decode_plan``, ``gemv_plan``,
``ffn_plan``); the kernels tile exactly as the plan says. These tests hold
the plans to covering every position, row, column and reduction index
exactly once, to scratch and shared-memory sizes that match the grid, and
to the CTA counts chosen for each width: K1 splits S only into splits of
256 positions or more, up to about two CTAs per SM; K4 at decode rows
splits K only past its chunk cap, K3 and prefill-width K4 fill the card's
132 SMs.
"""
import pytest

pytest.importorskip("torch")

import numpy as np                                           # noqa: E402

from repro_torch.kernels.flash_decode import ops as fd        # noqa: E402
from repro_torch.kernels.fused_ffn.ops import (COLS, PAD,     # noqa: E402
                                               RING, ffn_plan)
from repro_torch.kernels.gemv.ops import (MAX_K_CHUNK,        # noqa: E402
                                          gemv_plan)

SMS = 132
SMEM_BYTES = 227 * 1024
# qwen2-0.5b's int8 projections: q/o, k/v, gate/up, down (K, N)
K4_SHAPES = [(896, 896), (896, 128), (896, 4864), (4864, 896)]
K4_ODD = [(100, 130), (1, 1), (17, 31), (4865, 897), (16, 4096)]
FFN_SHAPES = [(896, 4864), (200, 700), (1, 1), (64, 8), (1024, 4096)]
ROWS = [1, 8, 9, 16, 17, 32, 40, 128, 300]


def covered_once(extent, tile, count, allow_empty=False):
    """Tiles [i*tile, (i+1)*tile) clipped to the extent, i < count, hit
    every index in [0, extent) exactly once; none is empty unless
    ``allow_empty`` (then only trailing tiles past the extent are)."""
    hits = np.zeros(extent, np.int64)
    for i in range(count):
        lo, hi = i * tile, min((i + 1) * tile, extent)
        assert lo < hi or (allow_empty and lo >= extent), \
            f"tile {i} of {count} is empty (extent {extent})"
        hits[lo:hi] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("K,N", K4_SHAPES + K4_ODD)
def test_gemv_plan_covers_every_index_once(R, K, N):
    p = gemv_plan(R, K, N)
    assert p.grid == (-(-N // p.cols), -(-R // p.rows), p.k_splits)
    assert covered_once(N, p.cols, p.grid[0])
    assert covered_once(R, p.rows, p.grid[1])
    assert covered_once(K, p.k_chunk, p.k_splits)
    assert p.k_chunk % 16 == 0 and p.rows in (8, 32) and p.cols in (32, 64)
    # shared memory of one CTA: weight chunk (rows padded by 16 bytes) and
    # x tile, or the int32 partials of its 256 threads, whichever is larger
    smem = max(p.k_chunk * (p.cols + 16) + p.rows * p.k_chunk, 256 * 32 * 4)
    assert smem <= SMEM_BYTES


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("K,N", K4_SHAPES + K4_ODD)
def test_gemv_plan_scratch_matches_grid(R, K, N):
    p = gemv_plan(R, K, N)
    assert p.scratch == (p.k_splits * R * N if p.k_splits > 1 else 0)
    assert p.ctas == p.grid[0] * p.grid[1] * p.grid[2]


@pytest.mark.parametrize("K,N", K4_SHAPES)
def test_gemv_plan_splits_k_only_past_the_chunk_cap_at_decode_rows(K, N):
    """At 8 rows a CTA takes all of K up to MAX_K_CHUNK rows: measured on
    an H100 (tools/plan_sweep.py), one K chunk per CTA beats a split over
    two CTAs per SM at every projection of the path, because a split costs
    a ticket and a second round trip to L2. K=4864 takes the fewest chunks
    that fit."""
    p = gemv_plan(8, K, N)
    assert p.rows == 8
    assert p.k_splits == -(-K // MAX_K_CHUNK)
    assert p.scratch == (0 if K <= MAX_K_CHUNK else p.k_splits * 8 * N)


@pytest.mark.parametrize("K,N", K4_SHAPES)
def test_gemv_plan_fills_the_card_at_prefill_rows(K, N):
    """At 128 rows (4x the dp4a work per CTA) K is split until the grid
    holds about two CTAs per SM."""
    p = gemv_plan(128, K, N)
    assert SMS <= p.ctas <= 4 * SMS, p


@pytest.mark.parametrize("K,N", K4_SHAPES)
def test_gemv_plan_reads_weights_once_per_32_rows_at_prefill(K, N):
    assert gemv_plan(128, K, N).grid[1] == 4


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("D,F", FFN_SHAPES)
def test_ffn_plan_covers_every_index_once(D, F, R, itemsize):
    p = ffn_plan(R, D, F, itemsize)
    tiles = -(-R // p.rows)
    assert p.grid_gate_up == (-(-F // COLS), tiles, p.d_splits)
    assert p.grid_down == (-(-D // COLS), tiles, p.f_splits)
    assert covered_once(F, COLS, p.grid_gate_up[0])
    assert covered_once(D, COLS, p.grid_down[0])
    assert covered_once(R, p.rows, tiles)
    # the D chunks of a strip form one cluster of 1, 2, 4 or 8 CTAs
    assert p.d_splits in (1, 2, 4, 8)
    assert covered_once(D, p.d_chunk, p.d_splits, allow_empty=True)
    assert covered_once(F, p.f_chunk, p.f_splits)
    assert p.d_chunk % 16 == 0 and p.f_chunk % 16 == 0
    assert p.rows in (16, 32, 64)
    # shared memory: gate/up holds a ring of Wg and Wu rows and its x rows, down
    # its Wd chunk and h rows (f32), padded by PAD elements a row; both
    # reuse it for their warps' f32 partials (gate/up: two k slices of
    # 16 rows, else one; down: 128 rows in all)
    assert p.gate_up_smem == max(
        itemsize * (2 * RING * COLS + p.rows * (p.d_chunk + PAD)),
        4 * 2 * COLS * (32 if p.rows == 16 else p.rows))
    assert p.down_smem == max(
        p.f_chunk * COLS * itemsize + p.rows * (p.f_chunk + PAD) * 4,
        4 * 128 * COLS)
    assert max(p.gate_up_smem, p.down_smem) <= SMEM_BYTES


@pytest.mark.parametrize("R", [33, 64, 576, 1024])
def test_ffn_plan_takes_32_row_tiles_where_64_rows_do_not_fit(R):
    """f32 at internvl2's (and llama2-70b's) D = 8,192: a gate/up CTA's 64
    x rows of a 1,024-wide D chunk would take 313,344 bytes; 32-row tiles
    take 181,248 and cover every row once. bf16 keeps 64-row tiles."""
    D, F = 8192, 28672
    p = ffn_plan(R, D, F, 4)
    assert p.rows == 32 and p.grid_gate_up[1] == -(-R // 32)
    assert covered_once(R, p.rows, p.grid_gate_up[1])
    assert p.gate_up_smem == 4 * (2 * RING * COLS + 32 * (p.d_chunk + PAD))
    assert p.gate_up_smem <= SMEM_BYTES and p.down_smem <= SMEM_BYTES
    assert p.scratch == R * F + (p.f_splits * R * D if p.f_splits > 1 else 0)
    assert ffn_plan(R, D, F, 2).rows == 64


@pytest.mark.parametrize("R,D,itemsize", [(128, 32768, 4), (8, 131072, 2)])
def test_ffn_plan_refuses_chunks_past_shared_memory(R, D, itemsize):
    with pytest.raises(ValueError, match="shared memory"):
        ffn_plan(R, D, 64, itemsize)


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("D,F", FFN_SHAPES)
def test_ffn_plan_scratch_matches_grid(D, F, R):
    p = ffn_plan(R, D, F)
    split = p.f_splits * R * D if p.f_splits > 1 else 0
    assert p.scratch == R * F + split
    gu, dn = p.ctas
    assert gu == p.grid_gate_up[0] * p.grid_gate_up[1] * p.grid_gate_up[2]
    assert dn == p.grid_down[0] * p.grid_down[1] * p.grid_down[2]


@pytest.mark.parametrize("R", [1, 8])
def test_ffn_plan_fills_the_card_at_decode_rows(R):
    """qwen2-0.5b at decode rows: both passes run at least a CTA per SM;
    the down partials cost under 10% of the weight bytes."""
    D, F = 896, 4864
    p = ffn_plan(R, D, F)
    assert all(SMS <= n <= 4 * SMS for n in p.ctas), p
    weight_bytes = 3 * D * F * 2
    partial_bytes = 2 * 4 * p.f_splits * R * D        # written, read back
    assert partial_bytes < 0.1 * weight_bytes


@pytest.mark.parametrize("R,rows", [(8, 16), (16, 16), (32, 32), (128, 64)])
def test_ffn_plan_row_tiles(R, rows):
    """One weight pass serves 16, 32 or 64 rows: at the 128-row prefill
    the weights are read twice, not 16 times as with an 8-row tile."""
    p = ffn_plan(R, 896, 4864)
    assert p.rows == rows and p.grid_gate_up[1] == -(-R // rows)


# K1 at the decode shapes of the JAX package's configs: (G, hd, n_kv)
DECODE_CONFIGS = {
    "qwen2-0.5b": (7, 64, 2),
    "granite-3-2b": (4, 64, 8),
    "internlm2-1.8b": (2, 128, 8),
    "llama3.2-3b": (3, 128, 8),
    "llama2-70b": (8, 128, 8),
    "reduced": (2, 32, 2),
}
DECODE_S = [1, 15, 16, 17, 64, 192, 200, 1000, 4096, 32768]
DECODE_B = [1, 8, 64]


def _a16(x):
    return -(-x // 16) * 16


def _k1_smem(p, G, hd, isz):
    """K1's shared memory restated from the kernel's layout: ring stages of
    K and V rows (hd * itemsize + 16 bytes), int8 scales and live flags,
    or the merge buffers that reuse them, then 8 warps x 8 heads x 20
    floats of P tiles."""
    stage = 2 * _a16(p.tile * (hd * isz + 16)) + _a16(p.tile)
    if isz == 1:
        stage += 2 * _a16(p.tile * 4)
    merge = _a16(max(min(p.splits, 16), 8) * G * hd * 4) + \
        _a16((2 * max(p.splits, 8) * G + 16) * 4)
    return max(p.stages * stage, merge) + 8 * 8 * 20 * 4


@pytest.mark.parametrize("config", list(DECODE_CONFIGS))
@pytest.mark.parametrize("S", DECODE_S)
@pytest.mark.parametrize("B", DECODE_B)
def test_decode_plan_covers_every_position_once(B, S, config):
    """Splits cover [0, S) once and none is empty; each split's tiles cover
    it once; split and tile are multiples of 16; scratch, grid and shared
    memory match, for int8, bf16 and f32 KV."""
    G, hd, n_kv = DECODE_CONFIGS[config]
    for isz in (1, 2, 4):
        p = fd.decode_plan(B, n_kv, G, S, hd, isz)
        assert p.split % 16 == 0 and p.tile % 16 == 0
        assert p.grid == (n_kv, B, p.splits) and p.ctas == B * n_kv * p.splits
        assert covered_once(S, p.split, p.splits)
        for z in range(p.splits):
            length = min(p.split, S - z * p.split)
            assert covered_once(length, p.tile, -(-length // p.tile))
        assert p.tile <= fd.MAX_TILE
        assert (p.stages == 1) == (p.tile == p.split) and p.stages in (1, 2)
        assert p.scratch == (B * n_kv * p.splits * G * (hd + 2)
                             if p.splits > 1 else 0)
        assert p.smem == _k1_smem(p, G, hd, isz) <= SMEM_BYTES


@pytest.mark.parametrize("config", list(DECODE_CONFIGS))
@pytest.mark.parametrize("B", DECODE_B)
def test_decode_plan_cta_policy(B, config):
    """The policy the sweep settled on (tools/plan_sweep.py): one split,
    with no scratch and no ticket, where B*n_kv CTAs fill the 132 SMs;
    else splits of at least 256 positions (or all of S), and no more than
    about two CTAs per SM."""
    G, hd, n_kv = DECODE_CONFIGS[config]
    pairs = B * n_kv
    for S in DECODE_S:
        p = fd.decode_plan(B, n_kv, G, S, hd, 2)
        if pairs >= SMS:
            assert p.splits == 1 and p.scratch == 0
            continue
        assert p.split >= min(fd.MIN_SPLIT, _a16(S))
        assert p.ctas < 2 * SMS + pairs
        if S >= fd.MIN_SPLIT * -(-2 * SMS // pairs):
            assert p.ctas > 2 * SMS - pairs          # the CTA target binds


@pytest.mark.parametrize("S,splits", [(64, 1), (128, 1), (192, 1),
                                      (200, 1), (1000, 4), (4096, 16)])
def test_decode_plan_at_the_serving_batch(S, splits):
    """qwen2-0.5b at B=8: every KV bucket of the engine (<= 200 positions)
    runs one CTA per (row, KV head) over the whole bucket; a long context
    of 4096 splits into 16 splits of 256 positions, 256 CTAs."""
    for isz in (1, 2):
        p = fd.decode_plan(8, 2, 7, S, 64, isz)
        assert p.splits == splits and p.stages == 1
        assert p.split == (_a16(S) if splits == 1 else 256)


def test_decode_plan_overrides_and_refusals():
    """The sweep's variants: any multiple of 16 as split or tile; a split
    longer than a ring stage streams through two stages; other values and
    plans past shared memory raise."""
    p = fd.decode_plan(8, 2, 7, 4096, 64, 2, split=4096)
    assert p.splits == 1 and p.stages == 2 and p.tile < 4096
    p = fd.decode_plan(8, 2, 7, 4096, 64, 2, split=256, tile=64)
    assert p.tile == 64 and p.stages == 2
    for bad in (dict(split=24), dict(split=0), dict(tile=8),
                dict(tile=2048)):
        with pytest.raises(ValueError, match="multiple of 16"):
            fd.decode_plan(8, 2, 7, 4096, 64, 2, **bad)
    with pytest.raises(ValueError, match="shared memory"):
        fd.decode_plan(1, 1, 8, 2 ** 20, 128, 4, split=16)


# K1 groups wider than the kernel's n8 side and 1,024 columns: (G, hd) ->
# launches (qwen3-moe: 64 query heads over 4 KV heads, hd 128;
# recurrentgemma-9b: 16 query heads over one KV head, hd 256)
HEAD_RUNS = {(16, 128): 2, (16, 64): 2, (8, 256): 2, (12, 128): 2,
             (16, 256): 4, (24, 128): 3, (32, 128): 4, (4, 256): 1,
             (8, 128): 1, (4, 128): 1, (3, 128): 1, (1, 128): 1}


@pytest.mark.parametrize("G,hd", list(HEAD_RUNS))
@pytest.mark.parametrize("S", [1, 200, 4096])
def test_decode_plan_wide_groups_take_head_runs(G, hd, S):
    """A group past 8 heads or 1,024 columns is planned as equal runs of
    heads, one launch each, and every other field of the plan is that of
    one run's launch (its shared memory and scratch follow the run's
    heads); groups that fit take one launch."""
    for B, isz in ((1, 2), (8, 1), (64, 2)):
        p = fd.decode_plan(B, 4, G, S, hd, isz)
        assert p.runs == HEAD_RUNS[G, hd] and p.heads * p.runs == G
        assert p.heads <= fd.MAX_GROUP and p.heads * hd <= fd.MAX_GROUP_WIDTH
        one = fd.decode_plan(B, 4, p.heads, S, hd, isz)
        assert (one.runs, one.heads) == (1, p.heads)
        assert one.split == p.split and one.tile == p.tile
        assert p.smem == one.smem == _k1_smem(p, p.heads, hd, isz)
        assert p.scratch == one.scratch == (
            B * 4 * p.splits * p.heads * (hd + 2) if p.splits > 1 else 0)


@pytest.mark.parametrize("G,hd", [(36, 256), (11, 64), (40, 128),
                                  (64, 128)])
def test_head_runs_refuse_groups_past_two_launches(G, hd):
    """Groups that need more than MAX_HEAD_RUNS (4) launches, or that no
    equal runs of at most 8 heads cover (11 is prime), raise."""
    assert fd.MAX_HEAD_RUNS == 4
    with pytest.raises(ValueError, match="does not split"):
        fd.decode_plan(8, 4, G, 200, hd, 2)


def test_recurrentgemma_group_takes_four_runs():
    """recurrentgemma-9b: 16 query heads on one KV head of 256 are four
    runs of 4 heads (1,024 columns each), and the plan's shared memory
    fits for B 1-8 over ring extents 64, 256 and 2,048, bf16 and int8."""
    assert fd.head_runs(16, 256) == 4
    for B in (1, 2, 4, 8):
        for S in (64, 256, 2048):
            for isz in (2, 1):
                p = fd.decode_plan(B, 1, 16, S, 256, isz)
                assert (p.runs, p.heads) == (4, 4)
                assert p.smem <= SMEM_BYTES


def test_by_head_runs_interleaves_heads_back_in_place():
    """Each run passes heads [j*r, (j+1)*r) of every KV group, contiguous,
    and the outputs land where a one-launch call puts them: an identity
    ``fn`` gives q, its first column and its second back."""
    torch = pytest.importorskip("torch")
    B, n_kv, G, hd = 3, 4, 16, 8
    q = torch.arange(B * n_kv * G * hd, dtype=torch.float32).view(
        B, n_kv * G, hd)
    seen = []

    def fn(qr):
        assert qr.is_contiguous() and qr.shape == (B, n_kv * 8, hd)
        seen.append(qr.view(B, n_kv, 8, hd)[..., 0] // hd % G)
        return qr, qr[..., 0], qr[..., 1]

    o, m, l = fd.by_head_runs(fn, q, n_kv, 2)
    assert torch.equal(o, q) and torch.equal(m, q[..., 0]) \
        and torch.equal(l, q[..., 1])
    for j, heads in enumerate(seen):      # head index within the group
        assert torch.equal(heads, (torch.arange(8) + 8 * j).expand(
            B, n_kv, 8).to(heads.dtype))


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
def test_by_head_runs_of_the_plain_version_equal_one_call(hd, partial):
    """Two runs of 8 heads of the plain K1 version, interleaved back,
    equal the plain version over all 16 heads of each KV group (int8 KV,
    a kv_limit inside the extent)."""
    torch = pytest.importorskip("torch")
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.quant.int8 import quantize_kv
    g = torch.Generator().manual_seed(hd)
    B, n_kv, G, S = 2, 4, 16, 50
    q = torch.randn(B, n_kv * G, hd, generator=g)
    (k, ks), (v, vs) = (quantize_kv(torch.randn(B, n_kv, S, hd, generator=g))
                        for _ in range(2))
    mask = torch.rand(B, S, generator=g) < 0.7
    mask[:, 0] = True
    lim = torch.tensor(37, dtype=torch.int32)

    def plain(qr):
        out = flash_decode_ref(qr, k, v, mask, ks, vs, lim,
                               partial_stats=True)
        return out if partial else (out[0] / out[2].clamp_min(1e-30)[
            ..., None], out[1], out[2])

    runs = fd.by_head_runs(plain, q, n_kv, 2)
    whole = plain(q)
    for a, b in zip(runs, whole):
        assert torch.equal(a, b)
