"""Synthetic federated language task.

Copy of ``src/repro/data/synthetic.py`` (numpy, no framework).

Each of ``n_topics`` topics is a distinct seeded Markov chain (bigram
transition matrix) over the shared vocabulary. A client's local corpus mixes
topics according to its Dirichlet proportions (data/partition.py), making
the federation non-IID in a controlled, reproducible way. Next-token
accuracy on a balanced held-out set is the paper's "test accuracy" stand-in
(the assigned paper evaluates image classification; the mechanism —
non-IID local distributions — is what matters for the selection-policy
claims, and a Markov LM gives the transformer zoo a learnable target).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    vocab_size: int = 64
    n_topics: int = 8
    seq_len: int = 32
    concentration: float = 0.05  # peakedness of each topic's bigram rows
    seed: int = 0


def topic_matrices(cfg: TaskConfig) -> np.ndarray:
    """(n_topics, V, V) row-stochastic transition matrices."""
    rng = np.random.default_rng(cfg.seed)
    mats = rng.dirichlet(np.full(cfg.vocab_size, cfg.concentration),
                         size=(cfg.n_topics, cfg.vocab_size))
    return mats.astype(np.float64)


def sample_sequences(rng: np.random.Generator, mats: np.ndarray,
                     topic_mix: np.ndarray, n_seqs: int,
                     cfg: TaskConfig) -> np.ndarray:
    """Sample (n_seqs, seq_len) int32 token sequences; each sequence draws a
    topic from ``topic_mix`` then walks that topic's chain."""
    v, s = cfg.vocab_size, cfg.seq_len
    topics = rng.choice(cfg.n_topics, size=n_seqs, p=topic_mix)
    out = np.empty((n_seqs, s), dtype=np.int32)
    out[:, 0] = rng.integers(0, v, size=n_seqs)
    # vectorized chain walk: gumbel-max sampling from each row
    for t in range(1, s):
        rows = mats[topics, out[:, t - 1]]              # (n, V)
        u = rng.random((n_seqs, v))
        out[:, t] = np.argmax(np.log(rows + 1e-12) - np.log(-np.log(u)),
                              axis=1)
    return out


def balanced_eval_set(cfg: TaskConfig, n_per_topic: int = 32) -> np.ndarray:
    """Held-out set with equal topic representation (global objective)."""
    rng = np.random.default_rng(cfg.seed + 777)
    mats = topic_matrices(cfg)
    seqs = []
    for t in range(cfg.n_topics):
        mix = np.zeros(cfg.n_topics)
        mix[t] = 1.0
        seqs.append(sample_sequences(rng, mats, mix, n_per_topic, cfg))
    return np.concatenate(seqs, axis=0)


def bayes_optimal_accuracy(cfg: TaskConfig, n_eval: int = 4096) -> float:
    """Upper bound: accuracy of the true per-topic argmax predictor on the
    balanced eval mix (useful to contextualize learned accuracy)."""
    mats = topic_matrices(cfg)
    rng = np.random.default_rng(cfg.seed + 1234)
    acc = []
    for t in range(cfg.n_topics):
        mix = np.zeros(cfg.n_topics)
        mix[t] = 1.0
        seqs = sample_sequences(rng, mats, mix, n_eval // cfg.n_topics, cfg)
        pred = np.argmax(mats[t][seqs[:, :-1]], axis=-1)
        acc.append(np.mean(pred == seqs[:, 1:]))
    return float(np.mean(acc))
