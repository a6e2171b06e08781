"""Observability of the port: tracing spans, round metrics and the JSONL
run ledger (counterparts of ``src/repro/obs/trace.py``, ``metrics.py`` and
``ledger.py``)."""
from repro_torch.obs import ledger, metrics, trace
from repro_torch.obs.ledger import RunLedger
from repro_torch.obs.metrics import (AOU_BUCKET_EDGES, MetricsRegistry,
                                     aou_histogram, json_safe)
from repro_torch.obs.trace import Span, Tracer, span, tracing

__all__ = ["ledger", "metrics", "trace", "Span", "Tracer", "span",
           "tracing", "AOU_BUCKET_EDGES", "MetricsRegistry",
           "aou_histogram", "json_safe", "RunLedger"]
