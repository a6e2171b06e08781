from repro_torch.data.partition import ClientData, client_batches, partition_clients
from repro_torch.data.synthetic import (
    TaskConfig,
    balanced_eval_set,
    bayes_optimal_accuracy,
    sample_sequences,
    topic_matrices,
)

__all__ = [
    "ClientData", "client_batches", "partition_clients", "TaskConfig",
    "balanced_eval_set", "bayes_optimal_accuracy", "sample_sequences",
    "topic_matrices",
]
