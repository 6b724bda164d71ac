"""Data pipeline: DataProducer -> Batch Queue -> DataSet (paper §4 setData).

A copy of ``repro/data/pipeline.py`` (pure numpy): the same producers,
queue and stream state give the same batches from the same seed.

NNTrainer's ``setData`` process: a user-supplied DataProducer generates
examples, a background thread accumulates them into batch-sized chunks in a
bounded Batch Queue, and the training loop pops ready batches.  The same
structure here, with multi-host awareness: each host produces only its
data-parallel shard of the global batch (``host_batch_slice``).

Producers are deterministic functions of (epoch, index) so a restarted
host reproduces the exact stream — the property checkpoint/restart relies
on (the saved ``DataState`` pins the stream position).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataState:
    """Stream position — saved in checkpoints, restored on restart."""
    epoch: int = 0
    index: int = 0

    def as_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "index": self.index}

    @classmethod
    def from_dict(cls, d) -> "DataState":
        return cls(epoch=int(d["epoch"]), index=int(d["index"]))


Producer = Callable[[int, int, np.random.Generator], Dict[str, np.ndarray]]


def synthetic_lm_producer(vocab: int, seq_len: int) -> Producer:
    """Deterministic synthetic LM stream (self-seeded per (epoch, index)).

    Emits learnable structure — each sequence counts upward from a random
    start (``t[i+1] = t[i] + 1 mod vocab``) with occasional noise tokens —
    so training loss measurably decreases (uniform-random tokens would
    start AT the entropy floor and show nothing)."""
    def produce(epoch: int, index: int, _rng) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((epoch * 1_000_003 + index) & 0x7FFFFFFF)
        start = rng.integers(0, vocab)
        tokens = (start + np.arange(seq_len + 1)) % vocab
        noise = rng.random(seq_len + 1) < 0.05
        tokens = np.where(noise, rng.integers(0, vocab, seq_len + 1), tokens)
        tokens = tokens.astype(np.int32)
        return {"tokens": tokens[:-1], "targets": tokens[1:]}
    return produce


def file_lm_producer(path: str, vocab: int, seq_len: int) -> Producer:
    """Memory-mapped token file: examples are deterministic windows."""
    data = np.memmap(path, dtype=np.int32, mode="r")
    n_windows = max((len(data) - 1) // seq_len, 1)

    def produce(epoch: int, index: int, _rng) -> Dict[str, np.ndarray]:
        w = (epoch * 7919 + index) % n_windows
        chunk = np.asarray(data[w * seq_len: w * seq_len + seq_len + 1])
        if len(chunk) < seq_len + 1:
            chunk = np.pad(chunk, (0, seq_len + 1 - len(chunk)))
        chunk = np.clip(chunk, 0, vocab - 1).astype(np.int32)
        return {"tokens": chunk[:-1], "targets": chunk[1:]}
    return produce


def host_batch_slice(global_batch: int, host_id: int, n_hosts: int
                     ) -> Tuple[int, int]:
    per = global_batch // n_hosts
    return host_id * per, per


class BatchQueue:
    """Bounded queue of ready host-batches filled by a producer thread."""

    def __init__(self, producer: Producer, *, batch: int, state: DataState,
                 prefetch: int = 2, extra: Optional[Dict[str, Callable]] = None):
        self._producer = producer
        self._batch = batch
        self._state = state
        self._extra = extra or {}
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        epoch, index = self._state.epoch, self._state.index
        rng = np.random.default_rng(0)
        while not self._stop.is_set():
            examples = []
            for i in range(self._batch):
                examples.append(self._producer(epoch, index + i, rng))
            batch = {
                k: np.stack([ex[k] for ex in examples])
                for k in examples[0]
            }
            for k, fn in self._extra.items():
                batch[k] = fn(self._batch)
            index += self._batch
            state = DataState(epoch, index)
            try:
                self._q.put((batch, state), timeout=1.0)
            except queue.Full:
                index -= self._batch  # retry the same chunk
                continue

    def get(self, timeout: float = 60.0):
        """-> (host_batch dict of np arrays, DataState after this batch)."""
        return self._q.get(timeout=timeout)

    def close(self) -> None:
        self._stop.set()

    def __iter__(self) -> Iterator:
        while True:
            yield self.get()
