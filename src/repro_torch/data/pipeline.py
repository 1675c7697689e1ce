"""Data pipeline: deterministic synthetic token streams + binary memmap shards.

Two interchangeable sources behind one iterator protocol:

  * SyntheticTokens — deterministic PRNG stream with a Zipfian unigram mix and
    short-range Markov structure (so losses actually *decrease* under
    training and distillation has signal). Fully offline; step-indexed, so a
    restart at step k regenerates exactly the batch k (checkpoint/restart
    reproducibility without data-state checkpoints).
  * MemmapTokens — np.memmap over a flat uint16/uint32 token file (the
    FineWebEdu-style path on a real cluster), sharded by host.

Both yield {'tokens': (B_local, S+1) int32}; the train step derives inputs =
[:, :-1], labels = [:, 1:]. ``host_batch_slice`` computes this host's slice of
the global batch for multi-process running.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

VOCAB_MARKOV = 97  # small prime for the synthetic Markov kernel


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    batch: int                 # per-host batch
    seed: int = 0
    zipf_a: float = 1.2
    markov_weight: float = 0.7

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.batch, self.seq_len + 1
        # zipfian unigrams
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        probs /= probs.sum()
        uni = rng.choice(self.vocab_size, size=(b, s), p=probs)
        # short-range structure: token_t depends on token_{t-1} via affine map
        mark = np.empty_like(uni)
        mark[:, 0] = uni[:, 0]
        for t in range(1, s):
            mark[:, t] = (mark[:, t - 1] * VOCAB_MARKOV + 13) % self.vocab_size
        gate = rng.random((b, s)) < self.markov_weight
        out = np.where(gate, mark, uni)
        return {"tokens": out.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class MemmapTokens:
    path: str
    seq_len: int
    batch: int
    dtype: str = "uint16"
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n = len(self._data) - (self.seq_len + 1)
        assert self._n > 0, "token file smaller than one sequence"

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step, self.host_index))
        starts = rng.integers(0, self._n, size=self.batch)
        rows = np.stack([np.asarray(self._data[i:i + self.seq_len + 1]) for i in starts])
        return {"tokens": rows.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def host_batch_slice(global_batch: int, host_index: int, host_count: int) -> int:
    """Per-host batch size; global batch must divide evenly across hosts."""
    assert global_batch % host_count == 0, (global_batch, host_count)
    return global_batch // host_count


def make_source(vocab_size: int, seq_len: int, batch: int, *, seed: int = 0,
                path: Optional[str] = None, host_index: int = 0, host_count: int = 1):
    if path:
        return MemmapTokens(path=path, seq_len=seq_len, batch=batch, seed=seed,
                            host_index=host_index, host_count=host_count)
    return SyntheticTokens(vocab_size=vocab_size, seq_len=seq_len, batch=batch,
                           seed=seed + host_index)


def calibration_batches(source, num_batches: int):
    """First N step-indexed batches — the paper's ~10^3-sample calibration set."""
    return [source.batch_at(i) for i in range(num_batches)]
