"""Deterministic synthetic data pipeline (numpy only).

A copy of the reference package's ``repro.data.pipeline``: the same batches,
bit for bit, from the same seed.

* step-indexed PRNG: ``batch_at(step)`` is a pure function, so a restarted
  run resumes mid-stream with byte-identical data and no reader state;
* host slices: ``batch_at(step, lo, hi)`` makes only rows ``[lo, hi)``;
* prefetch: :meth:`SyntheticLM.iterate` makes ``batch(step + 1)`` on a
  thread while the caller works on ``batch(step)``.

The generator mixes Zipf-distributed unigrams with short Markov "phrases",
so a model can learn something; the last label of each row is masked
(-1).
"""

from __future__ import annotations

import dataclasses
import threading
from queue import Empty, Queue
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataState:
    """Resume token: everything needed to regenerate the stream."""
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d):
        return DataState(int(d["seed"]), int(d["step"]))


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, extra_shape: Optional[Tuple[int, ...]] = None):
        self.vocab = int(vocab)
        self.seq_len = int(seq_len)
        self.global_batch = int(global_batch)
        self.seed = int(seed)
        self.extra_shape = extra_shape
        # fixed Markov structure (derived from seed, not from step)
        r = np.random.default_rng(seed ^ 0x5EED)
        self._n_states = 64
        self._trans = r.integers(0, vocab, size=(self._n_states, 8))

    # -- pure batch(step) ----------------------------------------------------
    def batch_at(self, step: int, lo: int = 0,
                 hi: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Rows [lo, hi) of the global batch for `step` (host slice):
        int32 ``tokens`` and ``labels`` (B, S), float32 ``extra`` where the
        pipeline has an extra input shape."""
        hi = self.global_batch if hi is None else hi
        rows = []
        for b in range(lo, hi):
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 4099 + b)
            rows.append(self._row(rng))
        tokens = np.stack(rows).astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((tokens.shape[0], 1), -1, np.int32)],
            axis=1)
        out = {"tokens": tokens, "labels": labels}
        if self.extra_shape is not None:
            rng = np.random.default_rng(self.seed * 7919 + step)
            out["extra"] = (rng.standard_normal(
                (hi - lo,) + self.extra_shape[1:]) * 0.02).astype(np.float32)
        return out

    def _row(self, rng) -> np.ndarray:
        S = self.seq_len
        out = np.empty(S, np.int64)
        i = 0
        state = int(rng.integers(self._n_states))
        while i < S:
            if rng.random() < 0.3:   # zipf unigram burst
                n = min(int(rng.integers(1, 8)), S - i)
                z = rng.zipf(1.3, size=n)
                out[i:i + n] = np.minimum(z, self.vocab - 1)
                i += n
            else:                     # markov phrase
                n = min(int(rng.integers(2, 12)), S - i)
                for j in range(n):
                    tok = self._trans[state, int(rng.integers(8))]
                    out[i + j] = tok
                    state = int(tok) % self._n_states
                i += n
        return out

    # -- iteration with prefetch ----------------------------------------------
    def iterate(self, state: DataState, lo: int = 0,
                hi: Optional[int] = None,
                prefetch: int = 2) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """Yields ``(step, batch_at(step, lo, hi))`` from ``state.step`` on;
        a daemon thread keeps up to ``prefetch`` batches ready.  Closing
        the generator stops the thread."""
        q: Queue = Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = state.step
            while not stop.is_set():
                q.put((step, self.batch_at(step, lo, hi)))
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            while t.is_alive():   # unblock a worker waiting on a full queue
                try:
                    q.get_nowait()
                except Empty:
                    pass
                t.join(timeout=0.01)
