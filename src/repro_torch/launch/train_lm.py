"""End-to-end training example: a ~100M-parameter dense LM (the qwen2-0.5b
skeleton, slimmed) trained on the synthetic pipeline with checkpoints,
then a simulated node failure: the job restarts and resumes from its
latest checkpoint. The port of ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 300] \
        [--device cpu]

The config is passed to ``train`` as an object (no registry entry is
added); the checkpoints go to a temporary directory, removed at the end.
Runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import train
from repro_torch.models.registry import count_params


def dense_100m():
    """The example's config: 8 layers, d_model 512, 8 heads of 64 over 4
    KV heads, d_ff 2048, a 32,000-token vocabulary, tied embeddings."""
    return get_config("qwen2-0.5b").replace(
        name="dense-100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=32000, tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)          # no GPU: raise before any work
    cfg = dense_100m()
    print(f"dense-100m params ~ {count_params(cfg) / 1e6:.0f}M")
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        half = args.steps // 2
        print(f"\n--- phase 1: train to step {half}, checkpoint every 50 ---")
        train(cfg, steps=half, batch=args.batch, seq=args.seq,
              reduced=False, ckpt_dir=ckpt, ckpt_every=50, log_every=25,
              device=args.device)
        print("\n--- simulated node failure: the process restarts and "
              "resumes from its checkpoint ---")
        _, opt, losses = train(cfg, steps=args.steps, batch=args.batch,
                               seq=args.seq, reduced=False, ckpt_dir=ckpt,
                               ckpt_every=100, log_every=25,
                               device=args.device)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    first, last = losses[0][1], losses[-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'IMPROVED' if last < first else 'no improvement'}); the "
          f"resumed job reached step {int(opt.step)}")
    return losses


if __name__ == "__main__":
    main()
