"""Streaming data pipeline: host -> device double-buffered ingestion.

Port of ``repro.data.pipeline``.  ``SyntheticTokens`` is host numpy, a
copy of the reference's: a deterministic token source, so training
runs are reproducible without a dataset.  ``Prefetcher`` keeps
``depth`` batches in flight on a background thread and moves each to
the device (pinned host memory, ``non_blocking`` copies on a side
stream on a CUDA device), handing them out in order.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device


class SyntheticTokens:
    """Deterministic LM token stream: per-step seeded, zipf-ish marginals
    (cheap stand-in for web-text token statistics)."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab, self.seq_len, self.batch, self.seed = vocab, seq_len, batch, seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        z = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        tok = (z - 1) % self.vocab
        return {"tokens": tok[:, :-1].astype(np.int32),
                "labels": tok[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread double buffering (the mmap write-behind analogue):
    keeps ``depth`` batches of host arrays in flight between ``source``
    and ``device`` (``None``: the card).  On a CUDA device each batch is
    copied from pinned memory on a side stream; the consumer's stream
    waits for that copy when it takes the batch.  ``close`` stops the
    thread."""

    def __init__(self, source: Iterator[dict], depth: int = 2,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._src = source
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _put(self, item: dict):
        if self._stream is None:
            return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                    for k, v in item.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: torch.as_tensor(np.asarray(v)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in item.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _work(self):
        for item in self._src:
            if self._stop.is_set():
                return
            self._q.put(self._put(item))
        self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is None:
            raise StopIteration
        batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            # the side stream allocated these: keep them alive until the
            # consumer's work on them is done
            for t in batch.values():
                t.record_stream(consumer)
        return batch

    def close(self):
        """Stop the thread: it ends after the source's next batch, once
        it finds room in the queue (emptied here until it has ended)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()
