"""Deterministic synthetic LM data pipeline.

The port's copy of ``repro.data.pipeline`` (numpy only): the same seed and
step give the same batch, bit for bit.  No real corpus is used; a
*structured* synthetic language makes the training loss meaningful (the
model has something to learn):

  - Zipfian unigram distribution over the vocab (like natural text),
  - a planted first-order Markov structure (each token biases a small set of
    successor tokens), so CE can drop well below the unigram entropy,
  - deterministic: batch t of a given (seed, config) is a pure function of
    (seed, t) — the pipeline is *stateless-resumable*: after a failure the
    restarted job asks for step t and gets byte-identical data (no iterator
    state in checkpoints).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # Zipf exponent
    markov_k: int = 4            # successors per token
    markov_p: float = 0.65       # prob mass on planted successors


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self.unigram = ranks ** (-cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # planted successor table: token v -> k preferred successors
        self.successors = rng.randint(0, V, size=(V, cfg.markov_k)).astype(np.int32)

    # ------------------------------------------------------------------
    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for global step `step` (pure function)."""
        cfg = self.cfg
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step) % (2**31 - 1)
        )
        V = cfg.vocab_size
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(V, size=B, p=self.unigram)
        for t in range(S):
            prev = toks[:, t]
            use_markov = rng.random_sample(B) < cfg.markov_p
            succ_pick = self.successors[
                prev, rng.randint(0, cfg.markov_k, size=B)
            ]
            indep = rng.choice(V, size=B, p=self.unigram)
            toks[:, t + 1] = np.where(use_markov, succ_pick, indep)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }

    # ------------------------------------------------------------------
    def unigram_entropy(self) -> float:
        p = self.unigram
        return float(-(p * np.log(p)).sum())

    def markov_entropy_bound(self) -> float:
        """Lower bound on achievable CE (entropy of the planted process)."""
        cfg = self.cfg
        hm = -(
            cfg.markov_p * np.log(cfg.markov_p / cfg.markov_k)
            + (1 - cfg.markov_p) * np.log(max(1 - cfg.markov_p, 1e-12))
        )
        return float(min(hm, self.unigram_entropy()))


def make_pipeline(
    vocab_size: int, seq_len: int, global_batch: int, seed: int = 0
) -> SyntheticLM:
    return SyntheticLM(DataConfig(vocab_size, seq_len, global_batch, seed))
