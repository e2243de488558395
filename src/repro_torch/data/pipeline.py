"""Deterministic synthetic token pipeline, host-sharded, prefetching: a
copy of the reference's ``data/pipeline.py`` (numpy only, so a batch is
bitwise the reference's for every ``(cfg, step)``).

Each host process generates only its shard of the global batch;
determinism comes from a counter-based PRNG (step, host), so a restart
after preemption sees the same batches; a background thread keeps
``prefetch`` batches ready.

The synthetic stream is a Zipf-ish unigram mixture with short-range
repetition structure, so cross-entropy decreases meaningfully during
training (a pure-uniform stream would pin loss at log V).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.35     # probability of copying a recent token
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(
        key=cfg.seed, counter=[0, 0, cfg.host_id, step]))


def synth_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """One host-shard batch for ``step`` (pure function of (cfg, step))."""
    rng = _batch_rng(cfg, step)
    b, s = cfg.host_batch, cfg.seq_len
    # zipf unigrams clipped to vocab
    base = rng.zipf(cfg.zipf_a, size=(b, s + 1)).astype(np.int64)
    base = (base - 1) % cfg.vocab_size
    # short-range repetition: with prob p, copy the token 1..8 back
    rep = rng.random((b, s + 1)) < cfg.repeat_p
    lag = rng.integers(1, 9, size=(b, s + 1))
    idx = np.maximum(np.arange(s + 1)[None, :] - lag, 0)
    seq = np.where(rep, np.take_along_axis(base, idx, axis=1), base)
    return {"tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32)}


class DataLoader:
    """Prefetching iterator over synth_batch(step)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
