"""Token data pipeline: deterministic synthetic corpus + sharded loader
(a copy of the reference's ``data/tokens.py``, numpy only; the reference
package's ``data/__init__.py`` imports jax modules).

The synthetic stream has learnable next-token structure (per-sequence
modular arithmetic progressions) so the end-to-end training example can
show a real loss drop without external data.  The loader mirrors a
production input pipeline: per-host sharding of the global batch,
background prefetch with a bounded queue (straggler smoothing), and
deterministic resume from an arbitrary step (checkpoint restart needs
the data stream to be replayable).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticTokens:
    """Deterministic infinite stream of (tokens, labels) batches."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, start_step: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.step = start_step

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        start = rng.integers(0, self.vocab, (self.batch, 1))
        delta = rng.integers(1, min(17, self.vocab), (self.batch, 1))
        t = np.arange(self.seq + 1)[None, :]
        seqs = (start + delta * t) % self.vocab
        tokens = seqs[:, :-1].astype(np.int32)
        labels = seqs[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            yield b


def shard_for_host(batch: dict, n_hosts: int, host_id: int) -> dict:
    """Per-host slice of the global batch (data-parallel input sharding)."""
    def slc(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: slc(v) for k, v in batch.items()}


class Prefetcher:
    """Bounded-queue background prefetch; absorbs producer jitter so a
    slow input step doesn't stall the accelerator (input-side straggler
    mitigation)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(it,),
                                        daemon=True)
        self._thread.start()

    def _run(self, it):
        try:
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
