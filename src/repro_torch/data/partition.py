"""Non-IID federated partitioner: per-client Dirichlet topic mixtures and
dataset sizes.

Copy of ``src/repro/data/partition.py`` (numpy, no framework).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.data.synthetic import TaskConfig, sample_sequences, topic_matrices


@dataclasses.dataclass
class ClientData:
    sequences: np.ndarray    # (n_i, seq_len) int32
    topic_mix: np.ndarray    # (n_topics,)

    @property
    def n_samples(self) -> int:
        return int(self.sequences.shape[0])


def partition_clients(fl: FLConfig, task: TaskConfig) -> list[ClientData]:
    """Create every client's local corpus. Dirichlet(alpha) topic mixtures;
    sizes uniform in ``fl.samples_per_client``."""
    rng = np.random.default_rng(fl.seed)
    mats = topic_matrices(task)
    lo, hi = fl.samples_per_client
    out = []
    for _ in range(fl.n_clients):
        mix = rng.dirichlet(np.full(task.n_topics, fl.dirichlet_alpha))
        n = int(rng.integers(lo, hi + 1))
        seqs = sample_sequences(rng, mats, mix, n, task)
        out.append(ClientData(sequences=seqs, topic_mix=mix))
    return out


def client_batches(rng: np.random.Generator, data: ClientData,
                   batch_size: int, epochs: int = 1):
    """Yield shuffled (batch, seq_len) batches covering ``epochs`` passes."""
    n = data.n_samples
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            yield data.sequences[order[i:i + batch_size]]
