"""Observability: metrics, µP health telemetry, phase tracing.

The port's counterpart of ``repro.obs``.  Three layers, shared by training,
serving and the sweep:

  - :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry with
    Prometheus text exposition + JSON snapshots, and percentile summaries;
  - :mod:`repro_torch.obs.telemetry` — online µP health: the train step
    emits coord-check statistics that stay on the card until a drain step
    reads them in one copy into a host ring buffer; a width-exponent drift
    detector flags scales that depart the parametrization's prediction
    (Fig. 5 as a monitor);
  - :mod:`repro_torch.obs.trace` — host-side span tracer (JSONL, monotonic
    clock) for request phases, sweep candidate lifecycles and train steps,
    with ``torch.profiler`` Chrome-trace capture.

Instrumentation is off by default everywhere, and never on the card for
serving: attaching a :class:`ServeObs` changes no token, no kernel launch
and no host sync of the engines (tests/test_torch_obs_serve.py, and
``chip_smoke.py``'s ``obs`` phase on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_prometheus,
    percentile_summary,
)
from repro_torch.obs.telemetry import (
    DriftDetector,
    DriftReport,
    RingBuffer,
    TrainObs,
    coord_size,
    flatten_stats,
    loglog_slope,
    update_ratios,
)
from repro_torch.obs.trace import PHASE_KERNELS, Tracer, load_jsonl


@dataclasses.dataclass
class ServeObs:
    """Serving-side observability bundle: pass to ``Engine(obs=...)`` /
    ``DynamicEngine(obs=...)``.  Purely host-side: the engines record into
    it around the read-backs they already make."""

    metrics: MetricsRegistry = dataclasses.field(
        default_factory=MetricsRegistry
    )
    tracer: Optional[Tracer] = None


__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "parse_prometheus",
    "percentile_summary",
    "DriftDetector",
    "DriftReport",
    "RingBuffer",
    "TrainObs",
    "ServeObs",
    "coord_size",
    "flatten_stats",
    "loglog_slope",
    "update_ratios",
    "PHASE_KERNELS",
    "Tracer",
    "load_jsonl",
]
