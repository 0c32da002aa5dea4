"""Online µP health telemetry: the paper's Fig-5 diagnostic as a monitor.

The port's counterpart of ``repro.obs.telemetry``.  The offline coordinate
check (core/coord_check.py) trains a *family* of widths and asserts
activation coordinate sizes stay Theta(1) in width under µP.  At production
scale the family is not trained again, but the proxy was, so the same
statistic runs *online*: the train step emits a dict of coordinate sizes
(per-layer residual stream, embedding, final norm, logits) and per-tensor
update-to-weight ratios, the host drains it into a :class:`RingBuffer`,
and a :class:`DriftDetector` compares the large run's scales against the
proxy baseline.  Under µP the log-log slope vs width of every tracked
activation is ~0; under SP the residual stream grows with width after a
few Adam steps and gets flagged before the run burns its budget.

The statistics are core.coord_check's (``coord_size`` = mean |x|,
``loglog_slope``), so the online records are comparable to the offline
golden fixtures (tests/test_torch_obs.py).  The train step's statistics
are 0-d and (n_groups,) tensors that stay on the card: :func:`to_host`
reads a whole record in one copy.  Record keys are the reference's,
character for character (``u2w/groups/0_attn/attn/wq``), so a
DriftDetector built from either package's records reads the other's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.coord_check import _coord_size, _loglog_slope

# the online telemetry and the offline coord check are the same statistics
coord_size = _coord_size
loglog_slope = _loglog_slope


def path_name(name: str) -> str:
    """The reference's 'groups/0_attn/attn/wq' key path name of a flat
    dotted param name ('groups.0_attn.attn.wq', core/meta.flatten_tree)."""
    return name.replace(".", "/")


def update_ratios(updates: Dict[str, torch.Tensor],
                  params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-tensor update-to-weight ratio: coord_size(update)/coord_size(w),
    a 0-d tensor on the params' device for each param, keyed by
    :func:`path_name` in the reference's (key-path sorted) order.
    Zero-scale weights (µP's zero-init query, offset-stored norm gains)
    report 0.0: the ratio is undefined there, not huge."""
    out = {}
    for name in sorted(params, key=lambda n: n.split(".")):
        psz = coord_size(params[name])
        ratio = coord_size(updates[name]) / (psz + 1e-30)
        out[path_name(name)] = torch.where(psz > 1e-12, ratio,
                                           torch.zeros_like(ratio))
    return out


def to_host(stats: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A record of device statistics as numpy arrays, in one device-to-host
    copy (one host sync, where a ``float()`` per statistic would sync ~70
    times a step)."""
    flat = torch.cat([v.detach().float().reshape(-1) for v in stats.values()])
    host = flat.cpu().numpy()
    out, i = {}, 0
    for k, v in stats.items():
        n = v.numel()
        out[k] = host[i:i + n].reshape(v.shape)
        i += n
    return out


def flatten_stats(stats: Dict[str, Any]) -> Dict[str, float]:
    """Flatten a (host-side) stats record into scalar floats: array-valued
    entries (per-group stacks) expand to ``key/i``."""
    out: Dict[str, float] = {}
    for k, v in stats.items():
        a = np.asarray(v)
        if a.ndim == 0:
            out[k] = float(a)
        else:
            for i, x in enumerate(a.reshape(-1)):
                out[f"{k}/{i}"] = float(x)
    return out


class RingBuffer:
    """Fixed-capacity record buffer the host drains telemetry into."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError("RingBuffer capacity must be >= 1")
        self.capacity = capacity
        self._records: List[Dict[str, float]] = []
        self.total = 0                      # records ever appended

    def append(self, record: Dict[str, Any]) -> None:
        self._records.append(flatten_stats(record))
        self.total += 1
        if len(self._records) > self.capacity:
            del self._records[0]

    def __len__(self) -> int:
        return len(self._records)

    @property
    def records(self) -> List[Dict[str, float]]:
        return list(self._records)

    def last(self, n: int = 1) -> List[Dict[str, float]]:
        return self._records[-n:]

    def series(self, key: str) -> np.ndarray:
        return np.asarray(
            [r[key] for r in self._records if key in r], np.float64
        )

    def mean_record(self, last_n: Optional[int] = None) -> Dict[str, float]:
        """Key-wise mean over the last ``last_n`` records (all if None):
        the baseline summary a DriftDetector is built from."""
        recs = self._records if last_n is None else self._records[-last_n:]
        if not recs:
            raise ValueError("RingBuffer is empty")
        keys = recs[0].keys()
        return {
            k: float(np.mean([r[k] for r in recs if k in r])) for k in keys
        }


@dataclasses.dataclass
class DriftReport:
    """Result of one drift check: per-statistic width exponents."""

    width: int
    base_width: int
    slopes: Dict[str, float]            # log-log slope vs width per stat
    flagged: Dict[str, float]           # |slope - expected| > tol subset

    @property
    def ok(self) -> bool:
        return not self.flagged

    def __str__(self) -> str:
        if self.ok:
            return (f"[mup-health] OK at width {self.width} "
                    f"(baseline {self.base_width})")
        worst = sorted(self.flagged.items(), key=lambda kv: -abs(kv[1]))
        desc = ", ".join(f"{k}: width^{s:+.2f}" for k, s in worst[:4])
        return (f"[mup-health] DRIFT at width {self.width} vs baseline "
                f"{self.base_width}: {desc}")


class DriftDetector:
    """Width-exponent drift detector: flags statistics whose scale departs
    the parametrization's prediction.

    Built from a *proxy-width baseline* (the tuning run already done):
    ``observe(width, stats)`` computes the log-log slope of each tracked
    statistic between (base_width, baseline) and (width, stats) — the
    two-point version of ``CoordCheckResult.growth`` — and flags entries
    where ``|slope - expected| > tol``.  Under µP/u-µP every tracked
    activation is Theta(1) in width (expected exponent 0).

    ``min_value`` guards the log against denormal statistics (a zero-init
    readout's step-0 logits are exactly 0 at every width: no drift signal
    there, and log(0) would poison the slope).
    """

    def __init__(self, base_width: int, baseline: Dict[str, float],
                 tol: float = 0.2, expected: float = 0.0,
                 keys: Optional[Sequence[str]] = None,
                 min_value: float = 1e-8):
        if base_width < 1:
            raise ValueError("base_width must be >= 1")
        self.base_width = int(base_width)
        self.baseline = dict(flatten_stats(baseline))
        self.tol = tol
        self.expected = expected
        self.keys = list(keys) if keys is not None else None
        self.min_value = min_value

    @classmethod
    def from_ring(cls, base_width: int, ring: RingBuffer,
                  last_n: Optional[int] = None, **kw) -> "DriftDetector":
        """Baseline = key-wise mean of the proxy run's last records."""
        return cls(base_width, ring.mean_record(last_n), **kw)

    def observe(self, width: int, stats: Dict[str, Any]) -> DriftReport:
        if width == self.base_width:
            # same width: no exponent to estimate — trivially in-spec
            return DriftReport(width, self.base_width, {}, {})
        cur = flatten_stats(stats)
        slopes: Dict[str, float] = {}
        flagged: Dict[str, float] = {}
        keys = self.keys if self.keys is not None else [
            k for k in cur if k in self.baseline
        ]
        for k in keys:
            b, c = self.baseline.get(k), cur.get(k)
            if b is None or c is None:
                continue
            if b < self.min_value and c < self.min_value:
                continue
            s = loglog_slope(
                (self.base_width, width),
                (max(b, self.min_value), max(c, self.min_value)),
            )
            slopes[k] = s
            if abs(s - self.expected) > self.tol:
                flagged[k] = s
        return DriftReport(width, self.base_width, slopes, flagged)


@dataclasses.dataclass
class TrainObs:
    """Training-side observability bundle, threaded through ``train_loop``
    (and ``Experiment.train(obs=...)``).

    - ``metrics``: registry for loss / grad-norm / step-time / tokens-sec;
    - ``telemetry``: build the train step with the µP-health statistics
      (per-layer activation coord sizes, logit scale, update-to-weight
      ratios); off by default, and when off the step is the plain one;
    - ``ring``: host buffer the statistics drain into (every ``every``
      steps, one device-to-host copy each);
    - ``detector``: optional online drift check against a proxy baseline;
    - ``tracer``: optional phase tracer (obs/trace.py).
    """

    metrics: Optional[Any] = None        # MetricsRegistry
    telemetry: bool = False
    every: int = 1
    ring: Optional[RingBuffer] = None
    detector: Optional[DriftDetector] = None
    tracer: Optional[Any] = None         # Tracer
    verbose: bool = True
    drift_reports: List[DriftReport] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.telemetry and self.ring is None:
            self.ring = RingBuffer()

    def record_step(self, step: int, *, loss: float, grad_norm: float,
                    dt: float, tokens: int, width: Optional[int] = None,
                    aux: Optional[Dict[str, Any]] = None) -> Optional[DriftReport]:
        """Host-side drain of one step's metrics (+ telemetry record,
        already on the host: :func:`to_host`).  Returns the drift report
        when a detector is attached and a telemetry record arrived."""
        if self.metrics is not None:
            self.metrics.counter(
                "train_steps_total", "optimizer steps run").inc()
            self.metrics.counter(
                "train_tokens_total", "tokens consumed").inc(tokens)
            self.metrics.gauge("train_loss", "last step loss").set(loss)
            self.metrics.gauge(
                "train_grad_norm", "last step global grad norm"
            ).set(grad_norm)
            self.metrics.histogram(
                "train_step_seconds", "wall time per optimizer step"
            ).observe(dt)
            self.metrics.gauge(
                "train_tokens_per_second", "last step throughput"
            ).set(tokens / max(dt, 1e-9))
        report = None
        if aux is not None:
            if self.ring is not None:
                self.ring.append(aux)
            if self.detector is not None and width is not None:
                report = self.detector.observe(width, aux)
                self.drift_reports.append(report)
                if self.metrics is not None and not report.ok:
                    self.metrics.counter(
                        "train_mup_drift_flags_total",
                        "telemetry records outside the parametrization's "
                        "predicted width scaling",
                    ).inc()
                if self.verbose and not report.ok:
                    print(str(report))
        return report
