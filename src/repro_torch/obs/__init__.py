"""Observability of the port: round metrics and the JSONL run ledger
(counterparts of ``src/repro/obs/metrics.py`` and ``obs/ledger.py``)."""
from repro_torch.obs import ledger, metrics
from repro_torch.obs.ledger import RunLedger
from repro_torch.obs.metrics import (AOU_BUCKET_EDGES, MetricsRegistry,
                                     aou_histogram, json_safe)

__all__ = ["ledger", "metrics", "AOU_BUCKET_EDGES", "MetricsRegistry",
           "aou_histogram", "json_safe", "RunLedger"]
