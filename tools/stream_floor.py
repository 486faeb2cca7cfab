"""Load-only floor of the K1 KV stream and the K3 and K4 weight streams on
one NVIDIA GPU.

    python3 tools/stream_floor.py

Builds ``tools/stream_floor.cu`` with nvcc for sm_90a and times a kernel
that only copies a matrix's bytes into shared memory (16-byte cp.async,
every copy in flight at once, no arithmetic) under the CTA layouts of the
port's kernels, the same way ``chip_smoke.py`` times them: device time by
CUDA events, launches queued back to back behind a spin kernel, inputs
rotated through copies larger than the L2. K1's layout is its K and V rows
at B=8, n_kv=2, hd=64, S=4096 as one stack of rows, each CTA taking the
rows of one split of its plan (and of smaller splits); the int8 scales
(0.5 MB) are left out. What a kernel takes beyond this
floor is its own work; the floor itself is the card's, for that many bytes
in one launch. Prints the card (nvidia-smi name, power limit) and one line
per layout.

    python3 tools/stream_floor.py --l2

times the same load-only kernel over ONE buffer of 4 to 32 MB read again
and again (warm: after the first launch it sits in the 50 MB L2), and over
a 512 MB buffer for comparison: the L2's read bandwidth that
``repro_torch.core.analytical.H100_SXM`` records.
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels.flash_decode.ops import decode_plan  # noqa: E402


def k1_layout(kv_itemsize: int):
    """K and V of B=8 x n_kv=2 x S=4096 positions of hd=64: rows of 64 *
    itemsize bytes, 2 * split rows per CTA (the plan's split, 256, 128)."""
    split = decode_plan(8, 2, 7, 4096, 64, kv_itemsize).split
    name = {1: "int8", 2: "bf16"}[kv_itemsize]
    row = 64 * kv_itemsize
    return (f"K1 K+V rows, B=8 n_kv=2 S=4096 hd=64 {name}", 2 * 8 * 2 * 4096,
            row, [(row, 2 * s) for s in sorted({split, 256, 128})])


# (what, rows K, row bytes N, [(strip bytes CB, rows per CTA KC), ...])
LAYOUTS = [
    k1_layout(2),
    k1_layout(1),
    ("K3 gate/up: Wg and Wu, 896 x 2*4864 bf16", 896, 2 * 2 * 4864,
     [(128, 224), (32, 896), (128, 112), (1024, 56)]),
    ("K3 down: Wd, 4864 x 896 bf16", 4864, 2 * 896,
     [(128, 256), (128, 128), (64, 608), (1792, 32)]),
    ("K4 down: 4864 x 896 int8", 4864, 896, [(64, 256), (896, 64)]),
    ("K4 gate/up: 896 x 4864 int8", 896, 4864, [(64, 224), (4864, 16)]),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_floor: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    out_dir = os.path.join(ROOT, "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libstream_floor.so")
    subprocess.run([build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so,
                    os.path.join(HERE, "stream_floor.cu")], check=True)
    fn = ctypes.CDLL(so).stream_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    out = torch.empty(1 << 16, device=dev)
    print(f"card: {chip_smoke.nvidia_smi()}")
    if "--l2" in sys.argv[1:]:
        return l2(fn, out, dev)
    for what, K, N, cases in LAYOUTS:
        nb = K * N
        var = [((torch.randint(0, 255, (nb,), dtype=torch.uint8,
                               device=dev),), {})
               for _ in range(max(2, math.ceil(2 * chip_smoke.L2_BYTES
                                               / nb)))]
        print(f"{what}: {nb / 1e6:.2f} MB, bytes over 3.35 TB/s "
              f"{nb / chip_smoke.HBM_BYTES_PER_S * 1e6:.2f} us")
        for CB, KC in cases:
            def run(w, CB=CB, KC=KC):
                err = fn(w.data_ptr(), out.data_ptr(), K, N, CB, KC,
                         torch.cuda.current_stream().cuda_stream)
                build.check(err, "stream_floor")
            ms = chip_smoke.time_ms(run, var, 200)
            ctas = N // CB * math.ceil(K / KC)
            print(f"  strips of {CB} B x {KC} rows, {ctas} CTAs of "
                  f"{CB * KC / 1024:.1f} KB: {ms * 1e3:.2f} us, "
                  f"{nb / ms / 1e9:.2f} TB/s", flush=True)
    return 0


def l2(fn, out, dev) -> int:
    """Warm reads of one buffer: rows of 4 KB, strips of 128 B x 64 rows
    (8 KB a CTA), so even 4 MB is 512 CTAs."""
    from repro_torch.kernels import build
    N, CB, KC = 4096, 128, 64
    for mb in (4, 8, 16, 24, 32, 512):
        nb = mb << 20
        K = nb // N
        w = torch.randint(0, 255, (nb,), dtype=torch.uint8, device=dev)

        def run(w, K=K):
            err = fn(w.data_ptr(), out.data_ptr(), K, N, CB, KC,
                     torch.cuda.current_stream().cuda_stream)
            build.check(err, "stream_floor")
        ms = chip_smoke.time_ms(run, [((w,), {})], 200)
        print(f"  l2 warm read of one {mb} MB buffer: {ms * 1e3:.2f} us, "
              f"{nb / ms / 1e9:.2f} TB/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
