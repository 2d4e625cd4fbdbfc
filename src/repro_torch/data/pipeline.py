"""Token data for training: the reference's ``SyntheticCorpus`` and
``PrefetchingLoader`` (``repro/data/pipeline.py``), copied so that the port
imports nothing of ``repro``.  The same seed gives the same token stream.

The WOW half of that module (``WowPrefetchPlanner``, ``MemmapCorpus``)
plans shard placement on the host and stays in the JAX package.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticCorpus:
    """Deterministic pseudo-corpus: shard i is reproducible from (seed, i)."""

    def __init__(self, vocab: int, seq_len: int, shard_tokens: int = 1 << 16,
                 seed: int = 0) -> None:
        self.vocab = vocab
        self.seq_len = seq_len
        self.shard_tokens = shard_tokens
        self.seed = seed

    def shard(self, i: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, i))
        # zipf-ish marginal so the loss has structure to learn
        z = rng.zipf(1.3, size=self.shard_tokens)
        return np.minimum(z, self.vocab - 1).astype(np.int32)

    def shard_bytes(self) -> int:
        return self.shard_tokens * 4


class PrefetchingLoader:
    """Double-buffered host loader: batch k+1 is made (and, through
    ``to_device``, moved to the card) while step k runs.  Each batch is
    {"tokens", "labels"}, (batch, seq_len) int32 arrays before
    ``to_device``."""

    def __init__(self, corpus, batch: int, seq_len: int, *,
                 to_device=None, depth: int = 2, seed: int = 0,
                 start_step: int = 0) -> None:
        self.corpus = corpus
        self.batch = batch
        self.seq_len = seq_len
        self.to_device = to_device or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._start_step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make_batch(self, step: int) -> dict:
        need = self.batch * (self.seq_len + 1)
        toks = self.corpus.shard(step)
        reps = -(-need // len(toks))
        toks = np.tile(toks, reps)[:need].reshape(self.batch,
                                                  self.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _worker(self) -> None:
        step = self._start_step
        while not self._stop.is_set():
            try:
                batch = self._make_batch(step)
                batch = {k: self.to_device(v) for k, v in batch.items()}
            except Exception as e:       # raised again by __next__
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> dict:
        batch = self._q.get()
        if isinstance(batch, Exception):
            raise batch
        return batch

    def __iter__(self):
        return self

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
