"""Observability of the port: the metric registry the server, the router
and the job and session managers expose (``metrics.py``) and trace-id
minting.  The tracer, the
scheduler's typed registry, the cost ledger, SLO and step anatomy come
with the observability slice (A10)."""

import uuid

from lmrs_tpu_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS_S,
                                        RATIO_BUCKETS, Counter, Gauge,
                                        Histogram, MetricsRegistry,
                                        add_label_to_exposition,
                                        merge_expositions)


def new_trace_id() -> str:
    """A fleet-unique trace id, minted at ingress (server or router)."""
    return uuid.uuid4().hex[:16]


__all__ = ["DEFAULT_LATENCY_BUCKETS_S", "RATIO_BUCKETS", "Counter", "Gauge",
           "Histogram", "MetricsRegistry",
           "add_label_to_exposition", "merge_expositions", "new_trace_id"]
