"""Observability carried from the JAX package: the metrics registry and
its canonical names, the flight recorder and its event names, the
worker-side span recorder and the coordinator's span store, the
per-tile trace log, the Chrome trace, the HTTP exporter (``/metrics``,
``/varz``, ``/healthz``), the timeseries sampler and the SLO burn
rates.  The fleet aggregator, ``top`` and the postmortem assembler come
with a later slice."""

from distributedmandelbrot_tpu_torch.obs.chrome import render_chrome_trace
from distributedmandelbrot_tpu_torch.obs.exporter import (MetricsExporter,
                                                          render_prometheus)
from distributedmandelbrot_tpu_torch.obs.flight import FlightRecorder
from distributedmandelbrot_tpu_torch.obs.metrics import (DEFAULT_BUCKETS,
                                                         Counter, Gauge,
                                                         Histogram, Registry)
from distributedmandelbrot_tpu_torch.obs.spans import (ClockOffsetEstimator,
                                                       OffsetEstimate, Span,
                                                       SpanRecorder,
                                                       SpanStore,
                                                       critical_path)
from distributedmandelbrot_tpu_torch.obs.trace import TraceEvent, TraceLog

__all__ = ["ClockOffsetEstimator", "Counter", "DEFAULT_BUCKETS",
           "FlightRecorder", "Gauge", "Histogram", "MetricsExporter",
           "OffsetEstimate", "Registry", "Span", "SpanRecorder",
           "SpanStore", "TraceEvent", "TraceLog", "critical_path",
           "render_chrome_trace", "render_prometheus"]
