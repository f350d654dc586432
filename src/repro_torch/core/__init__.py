"""Host-side fabric pieces of the port (so far only the metrics registry)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
