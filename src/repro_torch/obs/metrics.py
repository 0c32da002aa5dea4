"""Metrics registry: counter / gauge / histogram + Prometheus text exposition.

The port's own copy of ``repro.obs.metrics``: for the same sequence of
calls it writes the reference's Prometheus text byte for byte
(tests/test_torch_obs.py).  One shared implementation for everything the
port measures on the host:

  - the serving engines' request/token/cache counters and TTFT/ITL/step
    latency histograms (serving/engine.py),
  - train_loop's loss / grad-norm / step-time / tokens-per-sec gauges,
  - latency percentile summaries (``percentile_summary``).

Histograms keep their raw samples (bounded by ``max_samples``) in addition
to bucket counts, so quantiles are *exact* ``np.percentile`` values.
Export formats:

  - :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
    (version 0.0.4: ``# HELP`` / ``# TYPE`` + samples; histograms emit
    cumulative ``_bucket{le=...}`` rows plus ``_sum`` / ``_count``),
    round-trippable through :func:`parse_prometheus`;
  - :meth:`MetricsRegistry.snapshot` — a JSON-able dict (quantiles
    included), written by :meth:`MetricsRegistry.write_json`.

Everything here is plain host-side Python: nothing touches torch, so
recording a metric never launches a kernel or waits for the card.
"""
from __future__ import annotations

import bisect
import json
import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

# default buckets: latency-flavored seconds, SLO-ish spacing
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} is not a valid Prometheus name "
            "([a-zA-Z_:][a-zA-Z0-9_:]*)"
        )
    return name


class Counter:
    """Monotonically increasing value (requests served, tokens emitted)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self.value += n


class Gauge:
    """Point-in-time value (loss, pool occupancy, compile count)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Bucketed distribution that also keeps raw samples for exact quantiles.

    ``observe`` appends to both the cumulative-on-export bucket counts and a
    raw-sample list (capped at ``max_samples``; the cap only degrades
    quantiles to "over the most recent window", sum/count stay exact).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 max_samples: int = 65536):
        self.name = _check_name(name)
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0
        self.max_samples = max_samples
        self._samples: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        # first bucket whose upper bound covers v (le semantics: a value
        # equal to a bound lands in that bound's bucket); stored
        # non-cumulative, cumulated at export.  bisect, not np.searchsorted:
        # this sits on serving hot loops and a scalar numpy call costs ~10x
        # a bisect on the bucket tuple.
        i = bisect.bisect_left(self.buckets, v)
        self._counts[i] += 1
        if len(self._samples) >= self.max_samples:
            # sliding window: drop the oldest half in one go (amortized O(1))
            self._samples = self._samples[self.max_samples // 2:]
        self._samples.append(v)

    def observe_many(self, vs: Iterable[float]) -> None:
        """Bulk observe: one vectorized bucket pass instead of N scalar
        calls (end-of-serve TTFT/ITL batches are hundreds of samples)."""
        arr = np.asarray(vs if isinstance(vs, np.ndarray) else list(vs),
                         np.float64).ravel()
        if arr.size == 0:
            return
        self.sum += float(arr.sum())
        self.count += int(arr.size)
        idx = np.searchsorted(self.buckets, arr, side="left")
        for i, c in enumerate(np.bincount(idx, minlength=len(self._counts))):
            self._counts[i] += int(c)
        self._samples.extend(arr.tolist())
        if len(self._samples) > self.max_samples:
            self._samples = self._samples[-(self.max_samples // 2):]

    @property
    def samples(self) -> List[float]:
        return list(self._samples)

    def percentiles(self, pcts: Sequence[float] = (50, 95, 99)) -> Tuple[float, ...]:
        """Exact np.percentile over the retained raw samples."""
        if not self._samples:
            return tuple(float("nan") for _ in pcts)
        vals = np.percentile(np.asarray(self._samples, np.float64), list(pcts))
        return tuple(float(v) for v in np.atleast_1d(vals))

    def summary(self, pcts: Sequence[float] = (50, 95, 99), unit: float = 1.0,
                suffix: str = "") -> Dict[str, float]:
        """{"p50<suffix>": ..., ...} — the shared latency-summary shape."""
        vals = self.percentiles(pcts)
        return {
            f"p{int(p) if float(p).is_integer() else p}{suffix}": v * unit
            for p, v in zip(pcts, vals)
        }

    def cumulative_counts(self) -> List[int]:
        out, acc = [], 0
        for c in self._counts:
            acc += c
            out.append(acc)
        return out


Metric = Union[Counter, Gauge, Histogram]


def percentile_summary(samples: Sequence[float],
                       pcts: Sequence[float] = (50, 95, 99),
                       unit: float = 1e3,
                       suffix: str = "_ms") -> Dict[str, float]:
    """Latency-summary helper: exact np.percentile of ``samples`` (seconds)
    scaled by ``unit`` (default -> milliseconds), keyed
    ``p50_ms``/``p95_ms``/``p99_ms``.  Implemented on the obs Histogram so
    a latency summary and the serving metrics report the same statistic
    from the same code path.  Samples are scaled *before* the percentile,
    so the result is bit-identical to
    ``np.percentile(np.asarray(samples) * unit, pcts)``."""
    h = Histogram("percentile_summary_tmp", max_samples=max(len(samples), 1))
    h.observe_many(np.asarray(samples, np.float64) * unit)
    return h.summary(pcts, unit=1.0, suffix=suffix)


class MetricsRegistry:
    """Get-or-create metric registry with Prometheus/JSON export.

    Thread-safe for creation (the serving host loop and a scrape/writer
    thread may race); individual metric updates are plain float ops under
    the GIL, which is all the single-writer engines need.
    """

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw) -> Metric:
        name = self.prefix + name
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return (self.prefix + name) in self._metrics

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(self.prefix + name)

    def metrics(self) -> List[Metric]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """JSON-able snapshot: scalars verbatim, histograms as
        {count, sum, mean, p50, p95, p99, buckets}."""
        out: Dict[str, object] = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                p50, p95, p99 = m.percentiles((50, 95, 99))
                out[m.name] = {
                    "count": m.count,
                    "sum": m.sum,
                    "mean": (m.sum / m.count) if m.count else float("nan"),
                    "p50": p50, "p95": p95, "p99": p99,
                    "buckets": {
                        _fmt_le(b): c for b, c in
                        zip((*m.buckets, math.inf), m.cumulative_counts())
                    },
                }
            else:
                out[m.name] = m.value
        return out

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True,
                      default=float)
            f.write("\n")

    # ------------------------------------------------------------------
    def to_prometheus(self) -> str:
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for b, c in zip((*m.buckets, math.inf),
                                m.cumulative_counts()):
                    lines.append(
                        f'{m.name}_bucket{{le="{_fmt_le(b)}"}} {c}'
                    )
                lines.append(f"{m.name}_sum {_fmt_val(m.sum)}")
                lines.append(f"{m.name}_count {m.count}")
            else:
                lines.append(f"{m.name} {_fmt_val(m.value)}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())


def _fmt_le(b: float) -> str:
    return "+Inf" if math.isinf(b) else repr(float(b))


def _fmt_val(v: float) -> str:
    if float(v).is_integer() and abs(v) < 2 ** 53:
        return str(int(v))
    return repr(float(v))


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$'
)


def parse_prometheus(text: str) -> Dict[str, object]:
    """Parse text exposition back into {name: value} (counters/gauges) and
    {name: {"count", "sum", "buckets": {le: cumcount}}} (histograms).
    Strict enough for the round-trip test and the CI smoke check — rejects
    lines that are neither comments nor valid samples."""
    types: Dict[str, str] = {}
    out: Dict[str, object] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            types[name] = kind.strip()
            if kind.strip() == "histogram":
                out[name] = {"count": 0, "sum": 0.0, "buckets": {}}
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {raw!r}")
        name, labels, value = m.group("name", "labels", "value")
        v = float(value)
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            cand = name[: -len(suffix)] if name.endswith(suffix) else None
            if cand and types.get(cand) == "histogram":
                base = (cand, suffix)
                break
        if base is not None:
            cand, suffix = base
            h = out[cand]
            if suffix == "_bucket":
                le = dict(
                    kv.split("=", 1) for kv in (labels or "").split(",") if kv
                )["le"].strip('"')
                h["buckets"][le] = v
            elif suffix == "_sum":
                h["sum"] = v
            else:
                h["count"] = v
        else:
            if name not in types:
                raise ValueError(f"sample {name} has no # TYPE line")
            out[name] = v
    return out
