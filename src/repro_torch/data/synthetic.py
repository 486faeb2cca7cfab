"""Deterministic synthetic LM data: the port of ``repro.data.synthetic``.

A stationary Markov-like token stream (an affine map of the previous token
plus noise, so that the training loss falls), deterministic in (seed, step):
a restarted job resumes mid-epoch with byte-identical batches, and a
checkpoint stores only the step counter. Batches are numpy arrays made on
the host, the same bytes as the reference's for every family (``frames``
for the audio family, ``vision_embeds`` for the VLM). ``start`` runs a
prefetch thread that keeps up to ``prefetch`` batches ready; nothing runs
until it is called, and ``stop`` joins the thread.

On a mesh each rank takes its rows of the global batch (``rows``, the
data axes' cut: ``ShardingCtx.batch_rows``): the global stream is the same
at any mesh shape, so a run resumes on another mesh with the same data.

The reference's ``make_batch_specs`` returns JAX shape structs for its
ahead-of-time compiler; eager PyTorch needs no input specs, so it has no
counterpart here.
"""
from __future__ import annotations

import threading
from queue import Empty, Full, Queue
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig

_POLL_S = 0.05          # how often a blocked worker looks at the stop flag
JOIN_S = 60.0           # how long ``stop`` waits for the worker to end


class SyntheticLMData:
    """tokens[t+1] ~ affine permutation of tokens[t] + noise: learnable."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, noise: float = 0.1, prefetch: int = 2,
                 rows: Optional[Tuple[int, int]] = None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed, self.noise = seed, noise
        self.rows = rows
        self._q: Queue = Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic batch construction --------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch of ``step`` (its ``rows`` only, when given)."""
        v = self.cfg.vocab_size
        rng = np.random.Generator(
            np.random.Philox(key=self.seed + (step << 20)))
        a = 31337 % v or 1
        b = 917 % v
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=self.batch)
        noise_mask = rng.random((self.batch, self.seq)) < self.noise
        noise_tok = rng.integers(0, v, size=(self.batch, self.seq))
        for t in range(self.seq):
            nxt = (toks[:, t].astype(np.int64) * a + b) % v
            toks[:, t + 1] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (self.batch, self.cfg.encoder.n_frames, self.cfg.d_model),
                dtype=np.float32)
        if self.cfg.family == "vlm":
            out["vision_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.n_vision_tokens, self.cfg.d_model),
                dtype=np.float32)
        if self.rows is not None:
            out = {k: v[self.rows[0]:self.rows[1]] for k, v in out.items()}
        return out

    # -- async prefetch ---------------------------------------------------
    def start(self, from_step: int = 0) -> "SyntheticLMData":
        """Start the prefetch thread at ``from_step``; iterate for
        (step, batch) pairs in step order."""
        self.stop()
        self._stop.clear()

        def worker():
            step = from_step
            item = None
            while not self._stop.is_set():
                if item is None:
                    item = (step, self.batch_at(step))
                try:
                    self._q.put(item, timeout=_POLL_S)
                except Full:
                    continue
                item = None
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="synthetic-lm-prefetch")
        self._thread.start()
        return self

    def __iter__(self) -> Iterator:
        while True:
            yield self._q.get()

    def stop(self):
        """Stop the prefetch thread, join it and drop queued batches. The
        worker looks at the stop flag at least every 50 ms and after each
        batch it makes; one that has not ended after ``JOIN_S`` raises."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=JOIN_S)
            if self._thread.is_alive():
                raise RuntimeError("synthetic data: the prefetch thread did "
                                   f"not stop within {JOIN_S} s")
            self._thread = None
        while True:
            try:
                self._q.get_nowait()
            except Empty:
                break
