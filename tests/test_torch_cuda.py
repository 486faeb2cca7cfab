"""Card tests: each hand-written CUDA kernel against its plain PyTorch
version on the GPU, and the model path on CUDA against the CPU. They need
an NVIDIA GPU and nvcc and skip without them; on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np                                           # noqa: E402

from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.interop import to_device                    # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode.combine import (        # noqa: E402
    combine_partial_stats, merge_partial_stats)
from repro_torch.kernels.flash_decode.ops import (            # noqa: E402
    decode_plan, flash_decode)
from repro_torch.kernels.flash_decode.ref import (            # noqa: E402
    NEG_INF, flash_decode_ref)
from repro_torch.kernels.fused_ffn.ops import fused_ffn      # noqa: E402
from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref  # noqa: E402
from repro_torch.kernels.gemv.ops import gemv_int8_q         # noqa: E402
from repro_torch.kernels.gemv.ref import gemv_int8_ref       # noqa: E402
from repro_torch.kv.cache import (KVCache, batch_valid_mask,  # noqa: E402
                                  shard_view)
from repro_torch.models.attention import split_flash_decode  # noqa: E402
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.quant.int8 import quantize_int8, quantize_kv  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


PAIRS = [("float32", "float32"), ("float32", "int8"),
         ("bfloat16", "bfloat16"), ("bfloat16", "int8")]


def _fd_case(dev, B, S, pair, Hq=14, n_kv=2, hd=64, seed=0, lim=None):
    """Decode attention inputs over a bucket view of S positions cut from a
    cache of S + 8 (strided rows, as the engine passes them). Every row
    attends a position below ``lim`` (when lim > 0), the mask is False
    past it."""
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
    k, v = k[:, :, :S], v[:, :, :S]
    lim = S if lim is None else lim
    pos = torch.randint(0, max(1, min(lim, S)), (B,), device=dev,
                        generator=g)
    mask = torch.arange(S, device=dev)[None] < pos[:, None] + 1
    mask &= torch.arange(S, device=dev)[None] < lim
    return q, k, v, mask, ks, vs


def _check_k1(args, lim, partial, plan=None):
    """Kernel against its plain version within 1e-5 * max(1, max|plain|)
    per output tensor; a second call gives the same bits; kv_limit <= 0
    gives exactly 0 or (0, NEG_INF, 0)."""
    q, k, v, mask, ks, vs = args
    lim_t = torch.tensor(lim, dtype=torch.int32, device=q.device)
    if plan is None:
        got = flash_decode(q, k, v, mask, ks, vs, lim_t,
                           partial_stats=partial)
        again = flash_decode(q, k, v, mask, ks, vs, lim_t,
                             partial_stats=partial)
    else:
        got, again = (fd_ops.launch_plan(plan, pdl, q, k, v, mask, ks, vs,
                                         lim_t, partial_stats=partial)
                      for pdl in (True, False))
        if not partial:
            got, again = got[0], again[0]
    want = flash_decode_ref(q, k, v, mask, ks, vs, lim_t,
                            partial_stats=partial)
    got, again, want = ((x,) if not partial else x
                        for x in (got, again, want))
    for a, b, w in zip(got, again, want):
        tol = 1e-5 * max(1.0, float(w.abs().max()))
        assert float((a - w).abs().max()) <= tol
        assert torch.equal(a, b)
    if lim <= 0:
        assert not got[0].any()
        if partial:
            assert (got[1] == NEG_INF).all() and not got[2].any()


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "float32"])
@pytest.mark.parametrize("S", [64, 136])
def test_flash_decode_kernel_matches_plain(dev, kv, S):
    g = torch.Generator(device=dev).manual_seed(S)
    B, Hq, n_kv, hd = 4, 14, 2, 64
    qdt = torch.float32 if kv == "float32" else torch.bfloat16
    q = torch.randn(B, Hq, hd, device=dev, generator=g).to(qdt)
    kf = torch.randn(B, n_kv, S + 8, hd, device=dev, generator=g)
    vf = torch.randn(B, n_kv, S + 8, hd, device=dev, generator=g)
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        ks, vs = ks[:, :, :S], vs[:, :, :S]
    else:
        k, v, ks, vs = kf.to(qdt), vf.to(qdt), None, None
    k, v = k[:, :, :S], v[:, :, :S]          # a bucket view: strided rows
    pos = torch.randint(0, S, (B,), device=dev, generator=g)
    mask = torch.arange(S, device=dev)[None] < pos[:, None] + 1
    lim = (pos.max() + 1).to(torch.int32)
    for partial in (False, True):
        got = flash_decode(q, k, v, mask, ks, vs, lim, partial_stats=partial)
        want = flash_decode_ref(q, k, v, mask, ks, vs, lim,
                                partial_stats=partial)
        for a, b in zip(got if partial else (got,),
                        want if partial else (want,)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("S", [1, 17, 64, 200, 1000, 4096])
def test_flash_decode_kernel_matches_plain_across_splits(dev, S, B, pair):
    """qwen2-0.5b heads (G=7, hd=64) at every split count the plan gives
    from one to many: kv_limit at 0, inside a split, on a split edge and at
    S; normalised and partial statistics."""
    isz = torch.empty(0, dtype=getattr(torch, pair[1])).element_size()
    plan = decode_plan(B, 2, 7, S, 64, isz)
    edge = plan.split if plan.splits > 1 else S
    for lim in sorted({0, max(1, plan.split // 2 + 3), edge, S}):
        args = _fd_case(dev, B, S, pair, seed=S + B + lim, lim=lim)
        for partial in (False, True):
            _check_k1(args, lim, partial)


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("hd,G", [(128, 8), (32, 8), (256, 4), (128, 1)])
@pytest.mark.parametrize("S", [200, 4096])
def test_flash_decode_kernel_head_shapes(dev, S, hd, G, pair):
    """G*hd = 1024 (G=8, hd=128; G=4, hd=256), hd=32, and one query head
    per KV head."""
    for B in (1, 8):
        args = _fd_case(dev, B, S, pair, Hq=2 * G, n_kv=2, hd=hd,
                        seed=S + hd + G + B)
        for partial in (False, True):
            _check_k1(args, S, partial)


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("split", [16, 48, 4096])
def test_flash_decode_kernel_other_plans(dev, split, pair):
    """Plans other than the default (the sweep's variants): many small
    splits, a split that is no power of two, and one whole-S split that
    streams through the two-stage ring; with and without programmatic
    dependent launch."""
    S = 4096
    isz = torch.empty(0, dtype=getattr(torch, pair[1])).element_size()
    plan = decode_plan(8, 2, 7, S, 64, isz, split=split)
    assert (plan.stages == 2) == (split == S)
    for lim in (S, 1000):
        args = _fd_case(dev, 8, S, pair, seed=split + lim, lim=lim)
        for partial in (False, True):
            _check_k1(args, lim, partial, plan=plan)


@pytest.mark.parametrize("pair", PAIRS)
def test_flash_decode_kernel_unaligned_rows(dev, pair):
    """A K/V view whose base is not 16-byte aligned takes the element-copy
    path and gives the same result."""
    B, Hq, n_kv, hd, S = 8, 14, 2, 64, 200
    q, k, v, mask, ks, vs = _fd_case(dev, B, S, pair, seed=5)
    off = []
    for t in (k, v):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        u = flat[1:].view(B, n_kv, S, hd)
        u.copy_(t)
        off.append(u)
    assert off[0].data_ptr() % 16
    for partial in (False, True):
        _check_k1((q, off[0], off[1], mask, ks, vs), S, partial)


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("S,split", [(200, 32), (4096, 256), (4096, 4096)])
def test_flash_decode_kernel_dead_rows_follow_the_tile_walk(dev, S, split,
                                                            pair):
    """Rows with no live position below kv_limit: the kernel gives what
    the walk over its tiles gives (plain version per tile, LSE-merged in
    order), including the uniform average where every tile is dead."""
    isz = torch.empty(0, dtype=getattr(torch, pair[1])).element_size()
    plan = decode_plan(8, 2, 7, S, 64, isz, split=split)
    lim = S - 37
    q, k, v, mask, ks, vs = _fd_case(dev, 8, S, pair, seed=S + split,
                                     lim=lim)
    mask[:3] = False                       # three rows wholly dead
    lim_t = torch.tensor(lim, dtype=torch.int32, device=dev)
    parts = []
    for z in range(plan.splits):
        for lo in range(z * plan.split, min((z + 1) * plan.split, S),
                        plan.tile):
            hi = min(lo + plan.tile, (z + 1) * plan.split, S)
            sl = (slice(None), slice(None), slice(lo, hi))
            parts.append(flash_decode_ref(
                q, k[sl], v[sl], mask[:, lo:hi],
                None if ks is None else ks[sl],
                None if vs is None else vs[sl], lim_t - lo,
                partial_stats=True))
    o, m, l = (torch.stack(x) for x in zip(*parts))
    want_p = merge_partial_stats(o, m, l)
    want = combine_partial_stats(o, m, l)
    got_p = fd_ops.launch_plan(plan, True, q, k, v, mask, ks, vs, lim_t,
                               partial_stats=True)
    got = fd_ops.launch_plan(plan, True, q, k, v, mask, ks, vs, lim_t)[0]
    for a, w in zip((got, *got_p), (want, *want_p)):
        tol = 1e-5 * max(1.0, float(w.abs().max()))
        assert float((a - w).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,F", [(200, 700), (896, 4864)])
@pytest.mark.parametrize("R", [1, 3, 8, 16, 17, 32, 40, 128, 1024])
def test_fused_ffn_kernel_matches_plain(dev, dtype, D, F, R):
    """Row counts across the 16/32/64-row tiles (1,024: a drain batch
    prefill of 8 x 128), D=200 F=700 (no extent divides a tile) and the
    full qwen2-0.5b width. Within 1e-4 (absolute
    and relative) elementwise and 1e-4 * max(1, max|plain|) overall; a
    second call on the same inputs gives the same bits."""
    g = torch.Generator(device=dev).manual_seed(R + D)
    x = torch.randn(R, D, device=dev, generator=g).to(dtype)
    ws = [(torch.randn(s, device=dev, generator=g) / 20).to(dtype)
          for s in ((D, F), (D, F), (F, D))]
    for act in ("silu", "gelu"):
        got = fused_ffn(x, *ws, act=act)
        want = fused_ffn_ref(x, *ws, act=act)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max()))
        assert torch.equal(fused_ffn(x, *ws, act=act), got)


@pytest.mark.parametrize("R", [1, 8, 9, 17, 128])
@pytest.mark.parametrize("N", [128, 130, 896, 4864])
@pytest.mark.parametrize("K", [100, 896, 4864])
def test_gemv_int8_kernel_bit_exact(dev, K, N, R):
    """Every row tile (8 or 32), column strip (32 or 64, 130 not a multiple
    of 16) and K split of the plan, K=100 not a multiple of the 16-row
    chunk: bit-exact, and a second call gives the same bits."""
    g = torch.Generator(device=dev).manual_seed(K + N + R)
    xq = quantize_int8(torch.randn(R, K, device=dev, generator=g), axis=-1)
    wq = quantize_int8(torch.randn(K, N, device=dev, generator=g), axis=0)
    args = (xq.values, xq.scale, wq.values, wq.scale.reshape(1, -1))
    got = gemv_int8_q(*args)
    assert torch.equal(got, gemv_int8_ref(*args))
    assert torch.equal(gemv_int8_q(*args), got)


@pytest.mark.parametrize("over", [dict(dtype="float32"),
                                  dict(dtype="float32", kv_dtype="int8"),
                                  dict(dtype="float32", weight_int8=True)])
def test_decode_block_cuda_matches_cpu(dev, over):
    """The model path on CUDA (kernels) against the CPU (plain versions):
    same seeded weights, equal tokens, every kernel of the config
    launched."""
    cfg = get_config("qwen2-0.5b").reduced().replace(**over)
    out = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(build_model(cfg, device="cpu").init(0),
                           api.device)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 8), dtype=np.int64)).to(api.device)
        caches = api.init_caches(2, 32)
        for slot in range(2):
            single, lg = api.prefill(params, prompts[slot:slot + 1])
            caches = api.write_slot(caches, single, slot)
        reset_launch_counts()
        res = api.decode_block(
            params, caches, torch.zeros(2, dtype=torch.int32,
                                        device=api.device),
            torch.full((2,), 8, dtype=torch.int32, device=api.device),
            torch.ones(2, dtype=torch.bool, device=api.device),
            torch.full((2,), 6, dtype=torch.int32, device=api.device),
            torch.full((2,), -1, dtype=torch.int32, device=api.device),
            block_size=6, kv_bucket=16)
        out[d] = (res[1].cpu(), launch_counts())
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    counts = out["cuda"][1]
    assert counts["flash_decode"] > 0
    assert (counts["gemv_int8"] if over.get("weight_int8")
            else counts["fused_ffn"]) > 0



def _split_case(dev, bucket, n, kv, S=200, B=8, Hq=14, n_kv=2, hd=64,
                seed=0):
    """Split attention inputs at the engine's shapes: a bf16 query, one
    cache layer of S positions (bf16, or int8 with scales), its first
    ``bucket`` positions cut into ``n`` shard views; live rows end at
    random positions in the first 5/8 of the bucket (mid-shard, and with
    n=4 the last shard wholly past every row), rows 6 and 7 inactive with
    cursors past every live row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Hq, hd, device=dev, generator=g).to(torch.bfloat16)
    kf = torch.randn(B, n_kv, S, hd, device=dev, generator=g)
    vf = torch.randn(B, n_kv, S, hd, device=dev, generator=g)
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
    else:
        k, v, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, \
            None
    pos = torch.randint(0, bucket * 5 // 8, (B,), device=dev, generator=g)
    active = torch.arange(B, device=dev) < 6
    pos = torch.where(active, pos, torch.full_like(pos, bucket - 1))
    mask = batch_valid_mask(bucket, pos)
    lim = (torch.where(active, pos, -1).max() + 1).to(torch.int32)
    return (q, *shard_view(k, v, ks, vs, bucket, n)), mask, lim, active


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bucket", [64, 128, 192, 200])
def test_split_attention_kernel_matches_plain(dev, bucket, n, kv):
    """One K1 launch per shard in partial mode plus the LSE combine,
    against the plain route (the same function on CPU copies) within K1's
    tolerance on active rows; inactive rows may differ (a shard the
    kernel skips merges as the identity, the plain einsum computes it);
    a second call gives the same bits; no host sync."""
    (q, k, v, ks, vs), mask, lim, active = _split_case(dev, bucket, n, kv,
                                                      seed=bucket + n)
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = split_flash_decode(q, k, v, mask, ks, vs, kv_limit=lim)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert launch_counts()["flash_decode_partial"] == n
    again = split_flash_decode(q, k, v, mask, ks, vs, kv_limit=lim)
    cpu = [None if t is None else t.cpu() for t in (q, k, v, mask, ks, vs,
                                                     lim)]
    want = split_flash_decode(*cpu[:4], cpu[4], cpu[5], kv_limit=cpu[6])
    act = active.cpu()
    err = float((got.cpu()[act] - want[act]).abs().max())
    assert err <= 1e-5 * max(1.0, float(want[act].abs().max()))
    assert torch.equal(got, again)


@pytest.mark.parametrize("over", [dict(dtype="float32"),
                                  dict(dtype="float32", kv_dtype="int8")])
def test_drain_decode_and_split_block_cuda_match_cpu(dev, over):
    """The shared-cursor decode step (the drain path: every row at
    cache.length over the whole extent) and a split-KV decode block
    (a_shards=4) on CUDA against the CPU: equal tokens, every kernel of the
    path launched."""
    cfg = get_config("qwen2-0.5b").reduced().replace(**over)
    out = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(build_model(cfg, device="cpu").init(0),
                           api.device)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 8), dtype=np.int64)).to(api.device)
        cache, lg = api.prefill(params, prompts)
        twin = KVCache(*(None if t is None else t.clone()
                         for t in (cache.k, cache.v, cache.k_scale,
                                   cache.v_scale, cache.length)))
        tok = first = lg[:, -1].argmax(-1).to(torch.int32)
        reset_launch_counts()
        steps = []
        for _ in range(6):
            cache, lg = api.decode(params, cache, tok)
            tok = lg[:, 0].argmax(-1).to(torch.int32)
            steps.append(tok.cpu())
        drain_counts = launch_counts()
        reset_launch_counts()
        res = api.decode_block(
            params, twin, first,
            torch.full((2,), 8, dtype=torch.int32, device=api.device),
            torch.tensor([True, False], device=api.device),
            torch.full((2,), 6, dtype=torch.int32, device=api.device),
            torch.full((2,), -1, dtype=torch.int32, device=api.device),
            block_size=6, kv_bucket=32, kv_shards=4)
        out[d] = (torch.stack(steps), res[1].cpu(), drain_counts,
                  launch_counts())
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert torch.equal(out["cpu"][1], out["cuda"][1])
    drain, split = out["cuda"][2], out["cuda"][3]
    assert drain["flash_decode"] == 6 * cfg.n_layers
    assert drain["flash_decode_partial"] == 0 and drain["fused_ffn"] > 0
    assert split["flash_decode_partial"] == 6 * cfg.n_layers * 4


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_swap_pair_cuda_matches_cpu(dev, kv):
    """The swap pair on CUDA against the CPU on the same bytes: the export
    image, and the cache after importing it into another slot at a valid
    length inside a shard, equal bit for bit; positions at or past the
    valid length keep their bytes; a 4-shard view of the restored slot
    equals the CPU's."""
    from repro_torch.kv.cache import export_slot_kv, import_slot_kv
    cfg = get_config("qwen2-0.5b").reduced().replace(kv_dtype=kv)
    g = torch.Generator().manual_seed(0)
    cpu_api = build_model(cfg, device="cpu")
    base = cpu_api.init_caches(3, 40)
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(base, name)
        if t is None:
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 127, t.shape, generator=g))
        else:
            t.copy_(torch.rand(t.shape, generator=g))
    out = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        c = api.init_caches(3, 40)
        for name in ("k", "v", "k_scale", "v_scale"):
            if getattr(c, name) is not None:
                getattr(c, name).copy_(getattr(base, name))
        saved = export_slot_kv(c, 0)
        host = tuple(None if a is None else a.cpu() for a in saved)
        c = import_slot_kv(c, host, 2, 23)
        views = shard_view(c.k[0], c.v[0], None if c.k_scale is None
                           else c.k_scale[0], None if c.v_scale is None
                           else c.v_scale[0], 40, 4)
        out[d] = (host, tuple(None if t is None else t.cpu() for t in
                              (c.k, c.v, c.k_scale, c.v_scale)),
                  tuple(None if t is None else t.cpu() for t in views))
    for a, b in zip(out["cpu"][0] + out["cpu"][1] + out["cpu"][2],
                    out["cuda"][0] + out["cuda"][1] + out["cuda"][2]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    k = out["cuda"][1][0]
    assert torch.equal(k[:, 2, :, :23], base.k[:, 0, :, :23])
    assert torch.equal(k[:, 2, :, 23:], base.k[:, 2, :, 23:])


def test_preempt_restore_stream_cuda_matches_cpu(dev):
    """One preempt-then-restore serve (int8 KV, T=8, 2 slots, a
    high-priority arrival) on the card gives the CPU's streams, statuses
    and counters, and launches K1 and K3."""
    from repro_torch.runtime.serving import Request, ServingEngine
    cfg = get_config("qwen2-0.5b").reduced().replace(dtype="float32",
                                                      kv_dtype="int8")

    def plan():
        rng = np.random.default_rng(3)
        rs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8,
                                                 dtype=np.int32),
                      max_new_tokens=20, priority=0) for i in range(2)]
        rs.append(Request(rid=2, prompt=rng.integers(0, cfg.vocab_size, 6,
                                                     dtype=np.int32),
                          max_new_tokens=6, arrival_step=8, priority=5))
        return rs

    out = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(build_model(cfg, device="cpu").init(0),
                           api.device)
        eng = ServingEngine(api, 2, 8, max_new_cap=32, block_size=8,
                            kv_bucket_chunk=16, prefill_chunk=4,
                            preemptible=True, strict_invariants=True,
                            device=api.device)
        reqs = plan()
        reset_launch_counts()
        stats = eng.run(params, reqs, max_steps=600)
        out[d] = ({r.rid: (r.status, r.generated) for r in reqs},
                  {k: stats[k] for k in ("preemptions", "restores",
                                         "host_syncs", "completed")},
                  launch_counts())
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][1]["preemptions"] >= 1
    assert out["cuda"][1]["restores"] >= 1
    assert out["cuda"][2]["flash_decode"] > 0
    assert out["cuda"][2]["fused_ffn"] > 0


TIERS = dict(hot_window=4, kv_cold_block=4)        # ring of 8


@pytest.mark.parametrize("cold", ["bfloat16", "int8", "int4"])
def test_tiered_cache_functions_cuda_match_cpu(dev, cold):
    """The tiered cache functions on CUDA against the CPU on the same
    bytes (one layer of a 3-slot cache of 40 positions, ring of 8): ragged
    appends with an inactive row, the resolved read and its 2-shard views,
    a chunk whose residue wraps the ring and a chunk with valid < C (hot
    image before, cold image after each write), export and import at a
    valid length inside the extent: bit for bit."""
    from repro_torch.kv import cache as kc
    cfg = get_config("qwen2-0.5b").reduced().replace(
        dtype="float32", kv_cold_dtype=cold, **TIERS)
    g = torch.Generator().manual_seed(0)
    base = build_model(cfg, device="cpu").init_caches(3, 40)
    fields = ("k", "v", "k_scale", "v_scale", "hot_k", "hot_v")
    for name in fields:
        t = getattr(base, name)
        if t is None:
            continue
        t.copy_(torch.randint(-128, 128, t.shape, generator=g)
                if t.dtype == torch.int8 else torch.rand(t.shape, generator=g))
    n_kv, hd = cfg.n_kv_heads, cfg.head_dim
    appends = [(torch.randn(3, n_kv, hd, generator=g),
                torch.randn(3, n_kv, hd, generator=g),
                torch.tensor([0, 9, 20], dtype=torch.int32) + t,
                torch.tensor([True, t % 4 != 2, False])) for t in range(13)]
    chunks = [(0, 6, 12, 12), (1, 20, 5, 12)]     # (slot, start, valid, C)
    chunk_kv = [(torch.randn(n_kv, C, hd, generator=g),
                 torch.randn(n_kv, C, hd, generator=g))
                for _, _, _, C in chunks]
    out = {}
    for d in ("cpu", "cuda"):
        c = build_model(cfg, device=d).init_caches(3, 40)
        for name in fields:
            if getattr(c, name) is not None:
                getattr(c, name).copy_(getattr(base, name))
        lay = c.layer(0)
        res = []
        for kn, vn, pos, act in appends:
            kc.layer_append_tiered(*lay, kn.to(d), vn.to(d), pos.to(d), cold,
                                   act.to(d))
        res += [t.clone() for t in lay if t is not None]
        counts = torch.tensor([13, 22, 21], dtype=torch.int32, device=d)
        res += kc.layer_read_tiered(*lay, counts, 32, 4, 4, cold,
                                    dtype=torch.float32)
        res += kc.layer_read_tiered_shards(*lay, counts, 0, 2, 4, 4, cold,
                                           dtype=torch.float32)
        for (slot, start, valid, _), (kn, vn) in zip(chunks, chunk_kv):
            kn, vn = kn.to(d), vn.to(d)
            res += kc.chunk_hot_image(lay[4], lay[5], kn, vn, slot, start,
                                      valid, 40, dtype=torch.float32)
            kc.layer_write_chunk_tiered(*lay, kn, vn, slot, start, valid,
                                        cold)
            res += [t.clone() for t in lay if t is not None]
            res += kc.layer_read_slot_cold(*lay[:4], slot, cold,
                                           dtype=torch.float32)
        image = tuple(None if a is None else a.cpu()
                      for a in kc.export_slot_kv(c, 1))
        c = kc.import_slot_kv(c, image, 2, 17)
        res += [t for t in image if t is not None]
        res += [getattr(c, n) for n in fields if getattr(c, n) is not None]
        out[d] = [t.cpu() for t in res]
    assert len(out["cpu"]) == len(out["cuda"])
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cold", ["int8", "int4"])
def test_tiered_block_functions_cuda_match_cpu(dev, cold):
    """The tiered functions on a rank's block of a sequence-cut cache
    (``lo``: the two blocks of 20 of a 40-position extent, the ring
    whole), on CUDA against the CPU on the same bytes: ragged appends
    landing in either block, the resolved read of the block's part of a
    bucket, the hot image and the chunk write of a window across the
    block edge, and the import of the block's part below a global
    valid_len: bit for bit."""
    import dataclasses
    from repro_torch.kv import cache as kc
    cfg = get_config("qwen2-0.5b").reduced().replace(
        dtype="float32", kv_cold_dtype=cold, **TIERS)
    g = torch.Generator().manual_seed(1)
    base = build_model(cfg, device="cpu").init_caches(3, 40)
    fields = ("k", "v", "k_scale", "v_scale", "hot_k", "hot_v")
    for name in fields:
        t = getattr(base, name)
        t.copy_(torch.randint(-128, 128, t.shape, generator=g)
                if t.dtype == torch.int8 else torch.rand(t.shape, generator=g))
    n_kv, hd = cfg.n_kv_heads, cfg.head_dim
    appends = [(torch.randn(3, n_kv, hd, generator=g),
                torch.randn(3, n_kv, hd, generator=g),
                torch.tensor([3, 15, 30], dtype=torch.int32) + t,
                torch.tensor([True, t % 3 != 1, True])) for t in range(9)]
    kn_ch = torch.randn(n_kv, 12, hd, generator=g)
    vn_ch = torch.randn(n_kv, 12, hd, generator=g)
    out = {}
    for d in ("cpu", "cuda"):
        res = []
        for lo in (0, 20):
            c = dataclasses.replace(base, **{
                n: (getattr(base, n) if n.startswith("hot")
                    else getattr(base, n)[:, :, :, lo:lo + 20]).clone().to(d)
                for n in fields}, seq_lo=lo, seq_axes=("model",))
            lay = c.layer(0)
            for kn, vn, pos, act in appends:
                kc.layer_append_tiered(*lay, kn.to(d), vn.to(d), pos.to(d),
                                       cold, act.to(d), lo=lo)
            counts = torch.tensor([12, 24, 39], dtype=torch.int32, device=d)
            res += kc.layer_read_tiered(*lay, counts, 32 - lo, 4, 4, cold,
                                        dtype=torch.float32, lo=lo)
            kn, vn = kn_ch.to(d), vn_ch.to(d)
            res += kc.chunk_hot_image(lay[4], lay[5], kn, vn, 1, 14, 11, 20,
                                      dtype=torch.float32, lo=lo)
            kc.layer_write_chunk_tiered(*lay, kn, vn, 1, 14, 11, cold, lo=lo)
            res += [t.clone() for t in lay]
            image = tuple(a.cpu() for a in kc.export_slot_kv(c, 1))
            c = kc.import_slot_kv(c, image, 2, 27)
            res += [getattr(c, n) for n in fields]
        out[d] = [t.cpu() for t in res]
    assert len(out["cpu"]) == len(out["cuda"])
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("cold", ["int8", "int4"])
def test_tiered_decode_block_cuda_matches_cpu(dev, cold, shards):
    """Chunked prefill across the cold boundary, then one tiered decode
    block (T=6) on CUDA against the CPU: equal tokens, K1 (in partial mode
    when split) and K3 launched."""
    cfg = get_config("qwen2-0.5b").reduced().replace(
        dtype="float32", kv_cold_dtype=cold, **TIERS)
    out = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(build_model(cfg, device="cpu").init(0),
                           api.device)
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 12), dtype=np.int64)).to(api.device)
        caches = api.init_caches(2, 32)
        first = []
        for slot in range(2):
            for start in (0, 4, 8):
                caches, lg = api.prefill_chunk(
                    params, caches, prompts[slot:slot + 1, start:start + 4],
                    slot, start, 4)
            first.append(lg[0, -1].argmax())
        reset_launch_counts()
        res = api.decode_block(
            params, caches, torch.stack(first).to(torch.int32),
            torch.full((2,), 12, dtype=torch.int32, device=api.device),
            torch.ones(2, dtype=torch.bool, device=api.device),
            torch.full((2,), 6, dtype=torch.int32, device=api.device),
            torch.full((2,), -1, dtype=torch.int32, device=api.device),
            block_size=6, kv_bucket=32, kv_shards=shards)
        out[d] = (res[1].cpu(), launch_counts())
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    counts = out["cuda"][1]
    assert counts["flash_decode"] > 0 and counts["fused_ffn"] > 0
    assert (counts["flash_decode_partial"] > 0) == (shards > 1)


def test_tiered_budget_serve_cuda_matches_cpu(dev):
    """A tiered serve (int4 cold, monolithic admission, a_shards=2, T=8)
    under a byte budget that preempts, on the card and on the CPU: equal
    streams, counters and ``stats()["tiered"]``."""
    from repro_torch.runtime.serving import KVArbiter, Request, ServingEngine
    cfg = get_config("qwen2-0.5b").reduced().replace(
        dtype="float32", kv_cold_dtype="int4", **TIERS)

    def plan():
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8,
                                                   dtype=np.int32),
                        max_new_tokens=n, arrival_step=4 * i)
                for i, n in enumerate((20, 12, 8))]

    budget = KVArbiter(build_model(cfg, device="cpu").init_caches(
        2, 32, device="meta")).hot_bytes_per_token * 8
    out = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(build_model(cfg, device="cpu").init(0),
                           api.device)
        eng = ServingEngine(api, 2, 8, max_new_cap=24, block_size=8,
                            kv_bucket_chunk=16, a_shards=2, preemptible=True,
                            kv_budget_bytes=budget, device=api.device)
        reqs = plan()
        stats = eng.run(params, reqs, max_steps=1500)
        out[d] = ({r.rid: (r.status, r.generated) for r in reqs},
                  {k: stats[k] for k in ("preemptions", "restores",
                                         "host_syncs", "completed")},
                  stats["tiered"])
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][1]["preemptions"] >= 1


@pytest.mark.parametrize("which", ["kv_int8", "kv_int4", "rows_int8"])
def test_quantizers_cuda_match_cpu_bit_for_bit(dev, which):
    """The KV quantizers (int8, packed int4) and the per-row activation
    quantizer give the CPU's values and scales on CUDA. They divide by a
    tensor: PyTorch's CUDA division by a Python scalar multiplies by the
    reciprocal, which moved some scales by one ulp."""
    from repro_torch.quant.int4 import quantize_kv_int4
    fn = {"kv_int8": quantize_kv, "kv_int4": quantize_kv_int4,
          "rows_int8": lambda t: tuple(vars(quantize_int8(t, axis=-1))
                                       .values())}[which]
    x = torch.randn(64, 2, 200, 64, generator=torch.Generator()
                    .manual_seed(0))
    x[0, 0, :3] = 0.0                                  # all-zero rows
    for a, b in zip(fn(x), fn(x.to(dev))):
        assert torch.equal(a, b.cpu())


# ---------------------------------------------------------------------------
# the WA backend: the A domain on its own CUDA stream
# ---------------------------------------------------------------------------

def _wa_admitted(cfg, d, seed=0):
    """(api, params, caches): 4 slots of a (4, 32) cache admitted by
    chunked prefill (8-token prompts, chunks of 4) on device ``d``."""
    api = build_model(cfg, device=d)
    params = to_device(build_model(cfg, device="cpu").init(0), api.device)
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, 8), dtype=np.int64)).to(api.device)
    caches = api.init_caches(4, 32)
    for slot in range(4):
        for start in (0, 4):
            caches, _ = api.prefill_chunk(
                params, caches, prompts[slot:slot + 1, start:start + 4],
                slot, start, 4)
    return api, params, caches


def _clone_cache(c):
    import dataclasses
    return dataclasses.replace(c, **{
        f: None if getattr(c, f) is None else getattr(c, f).clone()
        for f in ("k", "v", "k_scale", "v_scale", "hot_k", "hot_v",
                  "length")})


def _block_args(dev_, T=6):
    return (torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=dev_),
            torch.full((4,), 8, dtype=torch.int32, device=dev_),
            torch.tensor([True, True, False, True], device=dev_),
            torch.tensor([T, 3, T, T], dtype=torch.int32, device=dev_),
            torch.full((4,), -1, dtype=torch.int32, device=dev_))


@pytest.mark.parametrize("over", [dict(dtype="float32"),
                                  dict(dtype="float32", kv_dtype="int8"),
                                  dict(dtype="float32", weight_int8=True),
                                  dict(kv_dtype="int8")])
def test_wa_depth_one_equals_colocated_bit_for_bit(dev, over):
    """At depth 1 the WA programs launch the colocated programs' kernels in
    the same order, QKV/FFN on the current stream and the KV side on the A
    stream: chunk logits, step logits and every cache byte are equal."""
    from repro_torch.core.wa import WADisaggregated
    cfg = get_config("qwen2-0.5b").reduced().replace(**over)
    api, params, caches = _wa_admitted(cfg, "cuda")
    wa = WADisaggregated(cfg, "cuda")
    got = {}
    for name, step, chunk in (
            ("colocated", api.decode_slotted, api.prefill_chunk),
            ("wa", wa.decode_step_slotted, wa.prefill_chunk)):
        c = _clone_cache(caches)
        tok, pos, act = _block_args(dev)[:3]
        logits = []
        for _ in range(4):
            c, lg = step(params, c, tok, pos, act, kv_bucket=16)
            logits.append(lg)
            tok, pos = lg[:, 0].argmax(-1).to(torch.int32), pos + 1
        row = torch.arange(4, device=dev)[None] + 7
        c, lg = chunk(params, c, row, 2, 12, 3)
        logits.append(lg[:, 0].expand(4, -1)[:, None])
        torch.cuda.synchronize()
        got[name] = (torch.cat(logits), c)
    (l0, c0), (l1, c1) = got["colocated"], got["wa"]
    assert torch.equal(l0, l1)
    for f in ("k", "v", "k_scale", "v_scale", "length"):
        a, b = getattr(c0, f), getattr(c1, f)
        assert (a is None) == (b is None) and (a is None or
                                               torch.equal(a, b)), f


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_wa_overlap_matches_cpu_and_repeats(dev, kv, depth, shards):
    """The pipelined decode block (T=6, one row idle, one halting after 3)
    on the card gives the CPU's tokens, and a second call from the same
    state gives the same tokens and cache bytes (the race check)."""
    from repro_torch.core.wa import WADisaggregated
    cfg = get_config("qwen2-0.5b").reduced().replace(dtype="float32",
                                                      kv_dtype=kv)
    toks = {}
    for d in ("cpu", "cuda"):
        api, params, caches = _wa_admitted(cfg, d)
        wa = WADisaggregated(cfg, d, overlap=depth, a_shards=shards)
        runs = []
        for _ in range(2 if d == "cuda" else 1):
            c = _clone_cache(caches)
            reset_launch_counts()
            out = wa.decode_block(params, c, *_block_args(api.device),
                                  block_size=6, kv_bucket=16)
            torch.cuda.synchronize()
            runs.append((out[1].cpu(), out[0].k.cpu(), launch_counts()))
        toks[d] = runs
    assert torch.equal(toks["cuda"][0][0], toks["cpu"][0][0])
    assert torch.equal(toks["cuda"][1][0], toks["cuda"][0][0])
    assert torch.equal(toks["cuda"][1][1], toks["cuda"][0][1])
    counts = toks["cuda"][0][2]
    assert counts["flash_decode"] > 0 and counts["fused_ffn"] > 0
    assert (counts["flash_decode_partial"] > 0) == (shards > 1)


@pytest.mark.parametrize("depth", [1, 2])
def test_wa_block_makes_no_synchronising_call(dev, depth):
    """A WA decode block (its forks, hops and joins included) runs under
    PyTorch's sync debug mode set to raise on any synchronising call."""
    from repro_torch.core.wa import WADisaggregated
    cfg = get_config("qwen2-0.5b").reduced().replace(kv_dtype="int8")
    api, params, caches = _wa_admitted(cfg, "cuda")
    wa = WADisaggregated(cfg, "cuda", overlap=depth)
    args = _block_args(dev)
    wa.decode_block(params, _clone_cache(caches), *args, block_size=4,
                    kv_bucket=16)
    torch.cuda.synchronize()
    c = _clone_cache(caches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wa.decode_block(params, c, *args, block_size=4, kv_bucket=16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_wa_program_join_leaves_no_a_work_pending(dev):
    """Each WA program joins the A stream back into the caller's: once the
    caller's stream has drained after a program returns, an event recorded
    on A is complete (decode step at depth 2, chunk, swap pair)."""
    from repro_torch.core.wa import WADisaggregated
    cfg = get_config("qwen2-0.5b").reduced().replace(kv_dtype="int8")
    api, params, caches = _wa_admitted(cfg, "cuda")
    wa = WADisaggregated(cfg, "cuda", overlap=2)
    w = torch.cuda.current_stream(dev)
    tok, pos, act = _block_args(dev)[:3]
    programs = (
        lambda: wa.decode_step_slotted(params, caches, tok, pos, act),
        lambda: wa.prefill_chunk(params, caches,
                                 torch.ones((1, 4), dtype=torch.int64,
                                            device=dev), 1, 8, 4),
        lambda: wa.swap_in_slot(caches, wa.swap_out_slot(caches, 3), 0, 8))
    for program in programs:
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)          # keep W busy past the return
        program()
        w.synchronize()
        assert wa._a.record_event().query()


# a spin long enough (~1 ms) that the host has issued the hop's consumer
# well before the slowed producer's output is written
SLOW_SPIN = 2_000_000


@pytest.mark.parametrize("slowed", ["pre_attention", "attend_decode_slotted",
                                    "post_attention"])
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_wa_hops_hold_under_slow_producers(dev, monkeypatch, kv, depth,
                                           slowed):
    """One op of the layer loop is made slow: a spin kernel runs on its
    stream just before it. Slow ln1 + QKV on W: an A stream that did not
    wait on the W -> A event would attend q/k/v before they are written.
    Slow attention on A: a W stream that did not wait on the A -> W event
    would read o early, and q/k/v not marked in use by A could have their
    memory handed to W's next micro-batch while A still reads them. Slow
    post-attention on W: o not marked in use by W could be reused by A.
    The decode block (T=6, one row idle, one halting after 3) still gives
    the CPU's tokens and, bit for bit, the cache bytes of a run without
    the spin."""
    from repro_torch.core import wa as wamod
    cfg = get_config("qwen2-0.5b").reduced().replace(dtype="float32",
                                                      kv_dtype=kv)
    api, params, caches = _wa_admitted(cfg, "cpu")
    want = wamod.WADisaggregated(cfg, "cpu", overlap=depth).decode_block(
        params, _clone_cache(caches), *_block_args("cpu"), block_size=6,
        kv_bucket=16)[1]
    api, params, caches = _wa_admitted(cfg, "cuda")
    wa = wamod.WADisaggregated(cfg, "cuda", overlap=depth)
    fields = ("k", "v", "k_scale", "v_scale", "length")

    def block():
        c = _clone_cache(caches)
        torch.cuda.synchronize()
        out = wa.decode_block(params, c, *_block_args(dev), block_size=6,
                              kv_bucket=16)
        torch.cuda.synchronize()
        return out[1].cpu(), [None if getattr(c, f) is None
                              else getattr(c, f).cpu() for f in fields]

    plain = block()
    fn = getattr(wamod, slowed)

    def spun(*a, **kw):
        torch.cuda._sleep(SLOW_SPIN)
        return fn(*a, **kw)

    monkeypatch.setattr(wamod, slowed, spun)
    toks, cache = block()
    assert torch.equal(plain[0], want)
    assert torch.equal(toks, want)
    for f, a, b in zip(fields, cache, plain[1]):
        assert (a is None) == (b is None) and (a is None or
                                               torch.equal(a, b)), f


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("S", [1, 200, 4096])
def test_flash_decode_kernel_wide_group_runs(dev, S, pair):
    """G = 16 query heads per KV head at hd 128 (qwen3-moe: 64 over 4):
    two launches of 8 heads over the same K/V, interleaved back, against
    the plain version over all 16; kv_limit at 0, inside and at S;
    normalised and partial. Each call counts its two launches."""
    B = 4
    for lim in sorted({0, max(1, S // 2), S}):
        args = _fd_case(dev, B, S, pair, Hq=64, n_kv=4, hd=128,
                        seed=S + lim, lim=lim)
        reset_launch_counts()
        for partial in (False, True):
            _check_k1(args, lim, partial)
        # _check_k1 makes two wrapper calls per mode, two launches each
        counts = launch_counts()
        assert counts["flash_decode"] == 8
        assert counts["flash_decode_partial"] == 4


# ---------------------------------------------------------------------------
# the recurrent families: K1 over the hybrid's ring at hd 256, K3 in its
# gelu mode, and the SSM and hybrid models on CUDA against the CPU
# ---------------------------------------------------------------------------

def _ring_case(dev, B, S, pair, pos, window, Hq=16, n_kv=1, hd=256, seed=0):
    """Decode attention inputs over one ring layer of S slots: the mask of
    ``slot_valid_mask(S, pos, window)`` for every row; the tile limit is
    min(pos + 1, S)."""
    from repro_torch.kv.cache import slot_valid_mask
    q, k, v, _, ks, vs = _fd_case(dev, B, S, pair, Hq=Hq, n_kv=n_kv, hd=hd,
                                  seed=seed)
    mask = slot_valid_mask(S, torch.tensor(pos, device=dev), window)
    return (q, k, v, mask[None].expand(B, S).contiguous(), ks, vs), \
        min(pos + 1, S)


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("S", [64, 256, 2048])
@pytest.mark.parametrize("groups", [(16, 1), (16, 4)])
def test_flash_decode_kernel_ring_hd256(dev, groups, S, pair):
    """recurrentgemma's attention: 16 query heads on one KV head of 256
    (four launches of 4 heads) and G=4 at hd 256 (one launch of 1,024
    columns), over a ring: the cursor at 0, mid-ring, at the last slot, and
    wrapped (window = S: every slot valid; window 3S/4: a run of valid
    slots across the wrap); normalised and partial."""
    Hq, n_kv = groups
    runs = fd_ops.head_runs(Hq // n_kv, 256)
    for pos, window in ((0, S), (S // 2, S), (S - 1, S), (S + S // 3, S),
                        (S + S // 3, 3 * S // 4)):
        args, lim = _ring_case(dev, 4, S, pair, pos, window, Hq, n_kv,
                               seed=S + pos + window)
        reset_launch_counts()
        for partial in (False, True):
            _check_k1(args, lim, partial)
        assert launch_counts()["flash_decode"] == 4 * runs


@pytest.mark.parametrize("R", [1, 8, 32, 128, 1024])
def test_fused_ffn_kernel_gelu_at_recurrentgemma_width(dev, R):
    """K3 in its gelu mode at D=4096, F=12288 (bf16) against its plain
    version within 1e-4 of max|plain|, repeatable."""
    g = torch.Generator(device=dev).manual_seed(R)
    D, F = 4096, 12288
    x = torch.randn(R, D, device=dev, generator=g).to(torch.bfloat16)
    ws = [(torch.randn(s, device=dev, generator=g) / s[0] ** 0.5)
          .to(torch.bfloat16) for s in ((D, F), (D, F), (F, D))]
    got = fused_ffn(x, *ws, act="gelu")
    want = fused_ffn_ref(x, *ws, act="gelu")
    assert (got - want).abs().max() <= 1e-4 * max(1.0, want.abs().max())
    assert torch.equal(fused_ffn(x, *ws, act="gelu"), got)


def test_ssm_cuda_matches_cpu(dev):
    """Reduced mamba2 in f32 on CUDA against the CPU: prefill, six slotted
    steps with one inactive row (whose state keeps its bytes), a chunked
    prompt; no port kernel launches (the SSD has none)."""
    cfg = get_config("mamba2-1.3b").reduced().replace(dtype="float32")
    src = build_model(cfg, device="cpu").init(0)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 21), dtype=np.int64))
    out = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(src, api.device)
        reset_launch_counts()
        st, lg = api.prefill(params, prompts.to(d))
        logits = [lg[:, -1].cpu()]
        keep = st.h[:, 2].clone()
        act = torch.tensor([True, True, False], device=d)
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        pos = torch.full((3,), 21, dtype=torch.int32, device=d)
        for _ in range(6):
            st, lg = api.decode_slotted(params, st, tok, pos, act)
            logits.append(lg[:2, 0].cpu())
            tok = lg[:, 0].argmax(-1).to(torch.int32)
        assert torch.equal(st.h[:, 2], keep)
        for start in (0, 8, 16):
            n = min(8, 21 - start)
            row = torch.zeros((1, 8), dtype=torch.long)
            row[0, :n] = prompts[0, start:start + n]
            st, lg = api.prefill_chunk(params, st, row.to(d), 2, start, n)
        logits.append(lg[:, -1].cpu())
        assert not any(launch_counts().values())
        out[d] = logits
    for a, b in zip(out["cpu"], out["cuda"]):
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()
        assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_hybrid_cuda_matches_cpu_and_launches_k1_k3(dev):
    """Reduced recurrentgemma in f32 on CUDA against the CPU: a 40-token
    prefill (ring of 32: rolled) and 30 decode steps that wrap the ring,
    logits at every step within 1e-4 of max|logit|; every decode step
    launches K1 once per attention layer per head run and K3 once per
    layer."""
    cfg = get_config("recurrentgemma-9b").reduced().replace(dtype="float32")
    src = build_model(cfg, device="cpu").init(0)
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40), dtype=np.int64))
    out = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(src, api.device)
        caches, lg = api.prefill(params, prompts.to(d))
        logits = [lg[:, -1].cpu()]
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        reset_launch_counts()
        for _ in range(30):
            caches, lg = api.decode(params, caches, tok)
            logits.append(lg[:, 0].cpu())
            tok = lg[:, 0].argmax(-1).to(torch.int32)
        out[d] = (logits, launch_counts())
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    counts = out["cuda"][1]
    runs = fd_ops.head_runs(cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
    assert counts["flash_decode"] == 30 * 1 * runs      # one ring layer
    assert counts["fused_ffn"] == 30 * cfg.n_layers
    assert counts["gemv_int8"] == 0


def test_recurrent_decode_makes_no_synchronising_call(dev):
    """A mamba2 decode block and two recurrentgemma drain steps (reduced,
    bf16) run under PyTorch's sync debug mode set to raise."""
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        cfg = get_config(arch).reduced()
        api = build_model(cfg, device="cuda")
        params = api.init(0)
        prompts = torch.zeros((4, 40), dtype=torch.long, device="cuda")
        caches, lg = api.prefill(params, prompts)
        tok = lg[:, -1].argmax(-1).to(torch.int32)

        def run():
            if api.decode_block is not None:
                z = torch.zeros(4, dtype=torch.int32, device="cuda")
                api.decode_block(params, caches, tok, z + 40, z == 0,
                                 z + 4, z - 1, block_size=4)
            else:
                c, lg = api.decode(params, caches, tok)
                api.decode(params, c, lg[:, 0].argmax(-1))
        run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the VLM and enc-dec families: K1 at whisper's heads (G=1, hd 64, 16 KV
# heads) over the cross K/V of 1,500 frames and the self cache, K3 at
# internvl2's width, and both models on CUDA against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("B", [1, 2, 8])
def test_flash_decode_kernel_whisper_shapes(dev, B, pair):
    """16 query heads on 16 KV heads of 64: the cross-attention over 1,500
    frames (all-true mask, no tile limit), and the self cache at extents
    160 and 288 (prompt + 128) with kv_limit at 1, inside, and at S."""
    args = _fd_case(dev, B, 1500, pair, Hq=16, n_kv=16, hd=64, seed=B)
    q, k, v, _, ks, vs = args
    ones = torch.ones((B, 1500), dtype=torch.bool, device=dev)
    for partial in (False, True):
        _check_k1((q, k, v, ones, ks, vs), 1500, partial)
    for S in (160, 288):
        for lim in (1, S // 2 + 3, S):
            args = _fd_case(dev, B, S, pair, Hq=16, n_kv=16, hd=64,
                            seed=S + B + lim, lim=lim)
            for partial in (False, True):
                _check_k1(args, lim, partial)


@pytest.mark.parametrize("dtype,R", [(torch.bfloat16, 1), (torch.bfloat16, 8),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 8), (torch.float32, 64),
                                     (torch.float32, 576)])
def test_fused_ffn_kernel_at_internvl2_width(dev, dtype, R):
    """D=8,192, F=28,672: bf16 at decode and admission rows; f32 past 32
    rows takes 32-row tiles (a 64-row tile's x rows do not fit shared
    memory). Tolerance as in ``test_fused_ffn_kernel_matches_plain``."""
    from repro_torch.kernels.fused_ffn.ops import ffn_plan
    D, F = 8192, 28672
    assert ffn_plan(R, D, F, torch.empty(0, dtype=dtype).element_size()) \
        .rows == (16 if R <= 16 else 32 if dtype == torch.float32 or R <= 32
                  else 64)
    g = torch.Generator(device=dev).manual_seed(R)
    x = torch.randn(R, D, device=dev, generator=g).to(dtype)
    ws = [(torch.randn(s, device=dev, generator=g) / s[0] ** 0.5).to(dtype)
          for s in ((D, F), (D, F), (F, D))]
    got = fused_ffn(x, *ws, act="silu")
    want = fused_ffn_ref(x, *ws, act="silu")
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max()))
    assert torch.equal(fused_ffn(x, *ws, act="silu"), got)


@pytest.mark.parametrize("over", [dict(dtype="float32"),
                                  dict(dtype="float32", weight_int8=True,
                                       kv_dtype="int8")])
def test_encdec_cuda_matches_cpu_and_launches_k1_twice_a_layer(dev, over):
    """Reduced whisper on CUDA against the CPU: prefill with frames and 12
    decode steps, both sides fed the CPU's tokens; logits at every step
    within 1e-4 of max|logit| and tokens equal in f32; within 2e-2 with
    int8 weights (the two sides may round an activation to neighbouring
    int8 steps, so a near tie may pick another argmax); each decode step
    launches K1 twice a decoder layer (self and cross), K3 never, K4 for
    every decoder linear with int8 weights."""
    cfg = get_config("whisper-medium").reduced().replace(**over)
    src = build_model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32))
    out, fed = {}, []
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(src, api.device)
        caches, lg = api.prefill(params, toks.to(d), frames.to(d))
        logits = [lg[:, -1].cpu()]
        reset_launch_counts()
        for i in range(12):
            if d == "cpu":
                fed.append(logits[-1].argmax(-1).to(torch.int32))
            caches, lg = api.decode(params, caches, fed[i].to(d))
            logits.append(lg[:, 0].cpu())
        out[d] = (logits, launch_counts())
    tol = 2e-2 if cfg.weight_int8 else 1e-4
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert (a - b).abs().max() <= tol * a.abs().max()
        if not cfg.weight_int8:
            assert torch.equal(a.argmax(-1), b.argmax(-1))
    counts = out["cuda"][1]
    assert counts["flash_decode"] == 12 * 2 * cfg.n_layers
    assert counts["fused_ffn"] == 0
    # q/k/v, o, cross q and o, w_in and w_out
    assert counts["gemv_int8"] == (12 * 8 * cfg.n_layers if cfg.weight_int8
                                   else 0)


def test_vlm_cuda_matches_cpu_and_launches_k1_k3(dev):
    """Reduced internvl2 in f32 on CUDA against the CPU: prefill with 4
    vision embeddings, then 8 slotted steps; logits within 1e-4 of
    max|logit|, tokens equal; each step launches K1 and K3 once a
    layer."""
    cfg = get_config("internvl2-76b").reduced().replace(dtype="float32")
    src = build_model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    vis = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    out = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(src, api.device)
        caches, lg = api.prefill(params, toks.to(d), vision_embeds=vis.to(d))
        logits = [lg[:, -1].cpu()]
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        pos = torch.full((2,), 12, dtype=torch.int32, device=d)
        on = torch.ones(2, dtype=torch.bool, device=d)
        reset_launch_counts()
        for _ in range(8):
            caches, lg = api.decode_slotted(params, caches, tok, pos, on)
            logits.append(lg[:, 0].cpu())
            tok = lg[:, 0].argmax(-1).to(torch.int32)
            pos = pos + 1
        out[d] = (logits, launch_counts())
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert (a - b).abs().max() <= 1e-4 * a.abs().max()
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    counts = out["cuda"][1]
    assert counts["flash_decode"] == 8 * cfg.n_layers
    assert counts["fused_ffn"] == 8 * cfg.n_layers
    assert counts["gemv_int8"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [17, 2048])
def test_fused_ffn_autograd_on_cuda_matches_plain(dev, dtype, R):
    """K3 with a gradient on the card: the forward launches the kernel
    once (never the plain version), and dx and the three weight gradients
    agree with autograd of ``fused_ffn_ref`` on the same CUDA tensors
    within 1e-4 (f32) / 8e-3 (bf16) of their largest magnitude."""
    g = torch.Generator(device=dev).manual_seed(R)
    x = torch.randn(R, 896, device=dev, generator=g).to(dtype)
    ws = [(torch.randn(s, device=dev, generator=g) / 30).to(dtype)
          for s in ((896, 4864), (896, 4864), (4864, 896))]
    dout = torch.randn(R, 896, device=dev, generator=g)
    tol = 1e-4 if dtype == torch.float32 else 8e-3
    for act in ("silu", "gelu"):
        a1 = [t.clone().requires_grad_(True) for t in (x, *ws)]
        reset_launch_counts()
        out = fused_ffn(*a1, act=act)
        assert launch_counts()["fused_ffn"] == 1
        got = torch.autograd.grad(out, a1, dout)
        a2 = [t.clone().requires_grad_(True) for t in (x, *ws)]
        want = torch.autograd.grad(fused_ffn_ref(*a2, act=act), a2, dout)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == dtype
            assert float((a.float() - b.float()).abs().max()) <= \
                tol * float(b.float().abs().max())


def test_train_step_cuda_matches_cpu(dev):
    """Reduced internlm2, f32: one ``train_step`` on the card (K3 forward
    and recompute, 2 launches a layer) against the CPU: the loss and the
    gradient norm within 1e-5, the first moment (0.1 x the clipped
    gradient) within 1e-4 of each leaf's largest magnitude plus 1e-6 of
    the largest. (The updated parameters are not compared: at step 0
    ``cosine_lr`` gives a learning rate of 0, so they equal the inputs on
    both sides and would show nothing. The first moment carries the
    step's clipped gradient.)"""
    from repro_torch.data.synthetic import SyntheticLMData
    from repro_torch.launch.train import batch_to_torch, train_step
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import tree_leaves
    cfg = get_config("internlm2-1.8b").reduced().replace(dtype="float32")
    src = build_model(cfg, device="cpu").init(0)
    host = SyntheticLMData(cfg, 2, 32, seed=0).batch_at(0)
    out = {}
    for d in ("cpu", "cuda"):
        api = build_model(cfg, device=d)
        params = to_device(src, api.device)
        reset_launch_counts()
        _, opt, info = train_step(params, adamw_init(params),
                                  batch_to_torch(host, api.device),
                                  loss=api.loss, steps=100)
        out[d] = (float(info["loss"]), float(info["grad_norm"]),
                  [t.cpu() for t in tree_leaves(opt.mu)], launch_counts())
    for i in (0, 1):
        assert abs(out["cpu"][i] - out["cuda"][i]) <= 1e-5 * out["cpu"][i]
    top = max(float(a.abs().max()) for a in out["cpu"][2])
    for a, b in zip(out["cpu"][2], out["cuda"][2]):
        assert float((a - b).abs().max()) <= \
            1e-4 * float(a.abs().max()) + 1e-6 * top
    assert out["cuda"][3]["fused_ffn"] == 2 * cfg.n_layers


# ---------------------------------------------------------------------------
# The collectives on CUDA tensors: two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

def test_collectives_on_cuda_tensors_match_the_cpu(dev):
    """``core/collectives.py`` on CUDA tensors of two gloo ranks sharing
    the card (all-reduce, all-gather, reduce-scatter straight through;
    send/recv and the ring staged through pinned host memory) give the CPU
    ranks' results bit for bit."""
    import torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn
    cuda = spawn(ranks.collectives_on, (1, 2), ("data", "model"),
                 device="cuda", share_device=True, timeout_s=300)
    cpu = spawn(ranks.collectives_on, (1, 2), ("data", "model"),
                timeout_s=300)
    for a, b in zip(cuda, cpu):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
