"""Shared fixtures. NOTE: no XLA device-count flags here — tests must see the
host's single device (multi-device behaviour is tested via subprocesses that
set the flag themselves; see test_distributed.py)."""
import jax
import numpy as np
import pytest



@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def make_batch(cfg, B=2, S=32, key=0):
    k = jax.random.key(key)
    batch = {"tokens": jax.random.randint(k, (B, S), 0, cfg.vocab_size),
             "labels": jax.random.randint(k, (B, S), 0, cfg.vocab_size)}
    if cfg.family == "audio":
        batch["frames"] = jax.random.normal(
            jax.random.key(key + 1), (B, cfg.encoder.n_frames, cfg.d_model))
    if cfg.family == "vlm":
        batch["vision_embeds"] = jax.random.normal(
            jax.random.key(key + 2), (B, cfg.n_vision_tokens, cfg.d_model))
    return batch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")
