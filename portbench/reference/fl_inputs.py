"""The FL cell's inputs, worked out again from the seed: the clients'
corpora, the static-iid wireless stream and each client's local batches.

Frozen copies (numpy, draw for draw) of the synthetic federated task
(``src/repro_torch/data/synthetic.py``: ``topic_matrices``,
``sample_sequences``), the Dirichlet partition and the batch order
(``data/partition.py``: ``partition_clients``, ``client_batches``) and the
static-iid scenario stream (``sim/numpy_ref.py`` with fixed mobility and
i.i.d. Rayleigh fading: ``core/noma.py``'s ``sample_distances`` and
``sample_gains``). The server consumes one ``np.random.Generator`` in a
documented order (``fl/server.py``): the scenario's init, then per round
the fading draw and each selected client's permutation in ascending
client order. ``Stream`` replays that order, so the reference trains on
the rows the program should have trained on, and holds them to the rows
it did.
"""
from __future__ import annotations

import numpy as np


def topic_matrices(task: dict) -> np.ndarray:
    rng = np.random.default_rng(task["seed"])
    v = task["vocab_size"]
    return rng.dirichlet(np.full(v, task["concentration"]),
                         size=(task["n_topics"], v)).astype(np.float64)


def sample_sequences(rng, mats, topic_mix, n_seqs: int, task: dict):
    v, s = task["vocab_size"], task["seq_len"]
    topics = rng.choice(task["n_topics"], size=n_seqs, p=topic_mix)
    out = np.empty((n_seqs, s), dtype=np.int32)
    out[:, 0] = rng.integers(0, v, size=n_seqs)
    for t in range(1, s):
        rows = mats[topics, out[:, t - 1]]
        u = rng.random((n_seqs, v))
        out[:, t] = np.argmax(np.log(rows + 1e-12) - np.log(-np.log(u)),
                              axis=1)
    return out


def client_corpora(n_clients: int, alpha: float, sizes: tuple, seed: int,
                   task: dict) -> list:
    """Each client's (n_i, seq_len) int32 corpus."""
    rng = np.random.default_rng(seed)
    mats = topic_matrices(task)
    lo, hi = sizes
    out = []
    for _ in range(n_clients):
        mix = rng.dirichlet(np.full(task["n_topics"], alpha))
        n = int(rng.integers(lo, hi + 1))
        out.append(sample_sequences(rng, mats, mix, n, task))
    return out


class Stream:
    """The server's generator, replayed: ``init`` draws the placements and
    CPU speeds, ``gains`` one round's channel gains, ``batches`` one
    client's local batches."""

    def __init__(self, seed: int, n: int, noma: dict, cpu_range_hz: tuple):
        self.rng = np.random.default_rng(seed)
        self.noma = noma
        r2 = self.rng.uniform(noma["min_radius_m"] ** 2,
                              noma["cell_radius_m"] ** 2, size=n)
        self.distances = np.sqrt(r2)
        self.cpu_freq = self.rng.uniform(cpu_range_hz[0], cpu_range_hz[1], n)

    def gains(self) -> np.ndarray:
        fading = self.rng.exponential(1.0, size=self.distances.shape)
        return (self.noma["ref_path_loss"]
                * self.distances ** (-self.noma["path_loss_exp"]) * fading)

    def batches(self, corpus: np.ndarray, batch: int, epochs: int) -> list:
        n = corpus.shape[0]
        out = []
        for _ in range(epochs):
            order = self.rng.permutation(n)
            out += [corpus[order[i:i + batch]]
                    for i in range(0, n - batch + 1, batch)]
        return out
