"""The serving engines' own latency histogram.

A copy of ``Histogram`` from ``mxnet_tpu/observability/metrics.py``
(cumulative buckets, Prometheus semantics), kept private to ``serving/``
so the engines read p50/p99 with telemetry off; the port of the metrics
registry (ROADMAP A12) takes its place.
"""

from __future__ import annotations

from ..base import MXNetError

#: default latency buckets (seconds): from a µs dispatch to seconds
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: dict) -> tuple:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=None):  # noqa: A002
        self.name = name
        self.help = help
        self._values = {}  # label key -> [bucket counts..., +Inf, sum, n]
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))

    def observe(self, value: float, **labels):
        key = _label_key(labels)
        rec = self._values.get(key)
        if rec is None:
            rec = self._values[key] = [0] * (len(self.buckets) + 1) + [0.0, 0]
        for i, b in enumerate(self.buckets):
            if value <= b:
                rec[i] += 1
                break
        else:
            rec[len(self.buckets)] += 1
        rec[-2] += value
        rec[-1] += 1

    def value(self, **labels) -> float:
        """Observation count for the label set."""
        rec = self._values.get(_label_key(labels))
        return rec[-1] if rec else 0

    def sum(self, **labels) -> float:
        rec = self._values.get(_label_key(labels))
        return rec[-2] if rec else 0.0

    def total(self) -> float:
        return sum(rec[-1] for rec in self._values.values())

    def quantile(self, q: float, **labels):
        """Estimated q-quantile (0..1) for the label set, interpolated
        linearly inside the containing bucket (Prometheus
        ``histogram_quantile`` semantics). ``None`` with no observations;
        observations beyond the last finite bucket clamp to it."""
        if not 0.0 <= q <= 1.0:
            raise MXNetError(f"quantile {q} outside [0, 1]")
        rec = self._values.get(_label_key(labels))
        if not rec or rec[-1] <= 0:
            return None
        rank = q * rec[-1]
        cum = 0
        for i, b in enumerate(self.buckets):
            prev_cum = cum
            cum += rec[i]
            if cum >= rank:
                lo = self.buckets[i - 1] if i else 0.0
                frac = (rank - prev_cum) / rec[i] if rec[i] else 1.0
                return lo + (b - lo) * frac
        return self.buckets[-1]
