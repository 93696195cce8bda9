"""Data pipeline: synthetic LM stream + packed binary token shards + prefetch.

* ``SyntheticLM``  — deterministic pseudo-text (Zipfian ngram chain) from a
  seed; restart-safe skip-ahead (``state = step index``), so a resumed run
  sees exactly the missed batches.
* ``PackedReader`` — the on-disk format: uint32 tokens in fixed-length
  records, memory-mapped, sharded by (process, data-parallel rank).
* ``Prefetcher``   — background-thread double buffering so host data prep
  overlaps device compute (straggler mitigation lever #1).

Host code, NumPy only: batches are ``np.ndarray`` dicts, the same bits as
the reference's (``repro.data.pipeline``) for the same seed and step.  The
training loop's ``put_batch`` moves a batch to the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticLM:
    """Deterministic, learnable synthetic language: a seeded sparse bigram
    chain with Zipfian unigrams — cross-entropy decreases during training,
    so the trainer shows real learning without a corpus."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab, self.seq_len, self.batch = vocab, seq_len, batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, vocab, size=(vocab, 4), dtype=np.int32)
        self._step = 0

    @property
    def state(self) -> int:
        return self._step

    def skip_to(self, step: int) -> None:
        self._step = step

    def next_batch(self) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed + 1) * 1_000_003 + self._step)
        self._step += 1
        b, s = self.batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        branch = rng.integers(0, 4, (b, s))
        noise = rng.random((b, s)) < 0.1
        rand = rng.integers(0, self.vocab, (b, s))
        for t in range(s):
            nxt = self._succ[toks[:, t], branch[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class PackedReader:
    """Reads fixed-length uint32 token records from a binary shard file,
    partitioned across data-parallel ranks; deterministic epoch shuffling."""

    HEADER = 16  # magic(4) version(4) seq_len(4) n_records(4)
    MAGIC = 0x52505244  # 'RPRD'

    @staticmethod
    def write(path: str, tokens: np.ndarray) -> None:
        """tokens: (n_records, seq_len+1) uint32."""
        n, s = tokens.shape
        with open(path, "wb") as f:
            np.array([PackedReader.MAGIC, 1, s, n], np.uint32).tofile(f)
            tokens.astype(np.uint32).tofile(f)

    def __init__(self, path: str, batch: int, rank: int = 0, world: int = 1, seed: int = 0):
        header = np.fromfile(path, np.uint32, 4)
        assert header[0] == self.MAGIC, f"bad magic in {path}"
        self.seq_plus = int(header[2])
        self.n_records = int(header[3])
        self._data = np.memmap(
            path, np.uint32, "r", offset=self.HEADER, shape=(self.n_records, self.seq_plus)
        )
        self.batch, self.rank, self.world, self.seed = batch, rank, world, seed
        self._step = 0

    @property
    def state(self) -> int:
        return self._step

    def skip_to(self, step: int) -> None:
        self._step = step

    def next_batch(self) -> dict[str, np.ndarray]:
        per_epoch = self.n_records // (self.batch * self.world)
        epoch, it = divmod(self._step, max(per_epoch, 1))
        order = np.random.default_rng(self.seed + epoch).permutation(self.n_records)
        base = (it * self.world + self.rank) * self.batch
        idx = order[base : base + self.batch]
        if len(idx) < self.batch:  # wrap small files
            idx = np.resize(idx, self.batch)
        recs = np.asarray(self._data[idx], np.int32)
        self._step += 1
        return {"tokens": recs[:, :-1], "labels": recs[:, 1:]}


class Prefetcher:
    def __init__(self, source, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            batch = self.source.next_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
