"""Deterministic, coordinator-free, host-sharded data pipeline (the port's
own numpy copy of ``repro.data.pipeline``: the same arrays bit for bit).

Every host computes its own shard of every global batch purely from
``(seed, step, host_id, num_hosts)`` — no data coordinator process to fail or
straggle, and restarts resume mid-epoch exactly (the step index *is* the
cursor).

Sources: synthetic token streams or a memory-mapped int32 token file;
both produce next-token-prediction (tokens, targets) pairs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ShardedLMPipeline:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    token_file: str | None = None     # memory-mapped corpus (optional)

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of num_hosts {self.num_hosts}")
        self.host_batch = self.global_batch // self.num_hosts
        self._tokens = None
        if self.token_file:
            self._tokens = np.memmap(self.token_file, dtype=np.int32,
                                     mode="r")

    def host_rows(self, step: int) -> np.ndarray:
        """Global row indices owned by this host at `step` (deterministic)."""
        start = step * self.global_batch + self.host_id * self.host_batch
        return np.arange(start, start + self.host_batch, dtype=np.int64)

    def batch(self, step: int) -> dict:
        rows = self.host_rows(step)
        if self._tokens is not None:
            n = self._tokens.size - (self.seq_len + 1)
            # fixed random permutation base; row -> offset, stateless
            offsets = ((rows * 2654435761 + self.seed) % n).astype(np.int64)
            seqs = np.stack([self._tokens[o:o + self.seq_len + 1]
                             for o in offsets])
        else:
            seqs = self._synthetic(rows)
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "targets": seqs[:, 1:].astype(np.int32)}

    def _synthetic(self, rows: np.ndarray) -> np.ndarray:
        """Structured synthetic LM task (learnable, not pure noise): a noisy
        order-1 Markov chain whose transition matrix is derived from the seed,
        so loss decreases measurably within a few hundred steps."""
        v = self.vocab
        rng = np.random.default_rng(self.seed)
        shift = rng.integers(1, max(v - 1, 2))
        out = np.empty((rows.size, self.seq_len + 1), dtype=np.int64)
        for i, r in enumerate(rows):
            g = np.random.default_rng(self.seed * 1_000_003 + int(r))
            x = np.empty(self.seq_len + 1, dtype=np.int64)
            x[0] = g.integers(v)
            noise = g.random(self.seq_len)
            rand = g.integers(v, size=self.seq_len)
            for t in range(self.seq_len):
                x[t + 1] = (x[t] * 3 + shift) % v if noise[t] > 0.15 \
                    else rand[t]
            out[i] = x
        return out
