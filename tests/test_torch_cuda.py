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
from repro_torch.kernels.flash_decode.ops import flash_decode  # noqa: E402
from repro_torch.kernels.flash_decode.ref import flash_decode_ref  # noqa
from repro_torch.kernels.fused_ffn.ops import fused_ffn      # noqa: E402
from repro_torch.kernels.fused_ffn.ref import fused_ffn_ref  # noqa: E402
from repro_torch.kernels.gemv.ops import gemv_int8_q         # noqa: E402
from repro_torch.kernels.gemv.ref import gemv_int8_ref       # noqa: E402
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.quant.int8 import quantize_int8, quantize_kv  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,F", [(200, 700), (896, 4864)])
@pytest.mark.parametrize("R", [1, 3, 8, 16, 17, 32, 40, 128])
def test_fused_ffn_kernel_matches_plain(dev, dtype, D, F, R):
    """Row counts across the 16/32/64-row tiles, D=200 F=700 (no extent
    divides a tile) and the full qwen2-0.5b width. Within 1e-4 (absolute
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

