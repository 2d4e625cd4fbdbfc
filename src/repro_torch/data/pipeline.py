"""Token data for training with WOW-planned shard prefetch: the reference's
``repro/data/pipeline.py``, copied so that the port imports nothing of
``repro``.  The same seed gives the same token stream.

The paper's insight applied to training input: the *shard fetch* for step
k+1..k+c_task is a COP that runs while step k computes, planned by the DPS
so the consuming host is always "prepared".  ``WowPrefetchPlanner`` maps
(host, step) to shard placements through the port's DPS
(``core/dps.py``); ``PrefetchingLoader`` executes the single-host plan
with a background thread.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from ..core import DataPlacementService, FileSpec


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


class MemmapCorpus:
    """Token shards cut from one ``.npy`` file of token ids, memory-mapped."""

    def __init__(self, path: str, shard_tokens: int = 1 << 20) -> None:
        self.tokens = np.load(path, mmap_mode="r")
        self.shard_tokens = shard_tokens

    def shard(self, i: int) -> np.ndarray:
        lo = (i * self.shard_tokens) % max(
            len(self.tokens) - self.shard_tokens, 1)
        return np.asarray(self.tokens[lo:lo + self.shard_tokens],
                          dtype=np.int32)

    def shard_bytes(self) -> int:
        return self.shard_tokens * 4


class WowPrefetchPlanner:
    """Plans which host should fetch/hold which data shard, WOW-style.

    Hosts are data-parallel workers; shard j of step k is consumed by host
    j % n_hosts.  Fetches are planned ``lookahead`` steps early (the step-3
    speculative COP analogue) and recorded in a DPS so a host losing its
    copy can re-pull from a peer instead of the blob store.
    """

    def __init__(self, n_hosts: int, shard_bytes: int,
                 lookahead: int = 2) -> None:
        self.n_hosts = n_hosts
        self.shard_bytes = shard_bytes
        self.lookahead = lookahead
        self.dps = DataPlacementService(seed=0)
        self._next_file = 0

    def plan_step(self, step: int) -> list[tuple[int, int]]:
        """Returns [(host, shard_id)] fetches to start *now* so that step
        ``step + lookahead`` finds its shards local."""
        target_step = step + self.lookahead
        fetches = []
        for host in range(self.n_hosts):
            shard_id = target_step * self.n_hosts + host
            fid = self._register(shard_id)
            if not self.dps.is_prepared((fid,), host):
                fetches.append((host, shard_id))
                # record the replica the fetch will create
                self.dps.add_replica(fid, host)
        return fetches

    def _register(self, shard_id: int) -> int:
        fid = shard_id
        if not self.dps.has_file(fid):
            self.dps.register_file(
                FileSpec(id=fid, size=self.shard_bytes, producer=-1),
                location=-1)
            self.dps.clear_replicas(fid)   # blob store only, no host yet
        return fid

    def recover_host(self, lost: int) -> int:
        """Drop a host's replicas; returns how many shards remain fetchable
        from peer hosts (vs. the blob store)."""
        peers = 0
        for fid in self.dps.file_ids():
            locs = self.dps.locations(fid)
            if lost in locs:
                self.dps.remove_replica(fid, lost, drop_empty=False)
                if locs - {lost}:
                    peers += 1
        return peers


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
