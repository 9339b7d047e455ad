"""Metrics registry: Counter / Gauge / Histogram with labels.

PyTorch counterpart of ``mxnet_tpu/observability/metrics.py`` (host code:
the same classes, names and output).

Reference analog: ``src/profiler/profiler.h`` (``ProfileCounter``,
``AggregateStats``) — generalized into a Prometheus-shaped model so the
same registry serves dispatch counters, compile-cache stats, kvstore
byte accounting and trainer gauges, and exports as text exposition.

Design constraints (the hot paths call into this per op dispatch):
- label sets are canonicalized to a sorted tuple of ``(key, value)``
  pairs; the common no-label case uses the empty tuple,
- value storage is a plain dict guarded by the GIL (single mutation per
  record — no lock),
- nothing here imports jax; the module is importable before backends.
"""

from __future__ import annotations

import threading

from ..base import MXNetError

#: default latency buckets (seconds) — spans µs-dispatch to multi-second
#: compile/allreduce times
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: dict) -> tuple:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def _fmt_value(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v) -> str:
    """Prometheus exposition label-value escaping: \\ " and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Metric:
    """Base metric: named, labeled, registered."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values = {}  # label key tuple -> float (or [..] for histogram)

    # -- read side -------------------------------------------------------
    def value(self, **labels) -> float:
        # float() here is what makes set_lazy work: a device scalar
        # stored by a gauge syncs at READ time, not on the hot path
        return float(self._values.get(_label_key(labels), 0.0))

    def total(self) -> float:
        """Sum across every label set (test/summary convenience)."""
        return float(sum(self._values.values()))

    def labelsets(self):
        return [dict(k) for k in self._values]

    def clear(self):
        self._values.clear()

    # -- exposition ------------------------------------------------------
    def expose(self) -> list:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._values):
            lines.append(
                f"{self.name}{_fmt_labels(key)} {_fmt_value(self._values[key])}"
            )
        return lines


class Counter(Metric):
    """Monotonically increasing value (per label set)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise MXNetError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(Metric):
    """Value that can go up and down (per label set)."""

    kind = "gauge"

    def set(self, value: float, **labels):
        self._values[_label_key(labels)] = float(value)

    def set_lazy(self, value, **labels):
        """Store ``value`` without coercing to float: an asynchronous
        device scalar (e.g. the fused step's in-graph grad norm) stays a
        future until someone reads the gauge — recording never blocks."""
        self._values[_label_key(labels)] = value

    def inc(self, amount: float = 1.0, **labels):
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=None):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))

    def observe(self, value: float, **labels):
        key = _label_key(labels)
        rec = self._values.get(key)
        if rec is None:
            # [per-bucket counts..., +Inf count, sum, count]
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
        observations beyond the last finite bucket clamp to it — the
        serving SLO report reads p50/p99 through this."""
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

    def expose(self) -> list:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._values):
            rec = self._values[key]
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += rec[i]
                le = 'le="%g"' % b
                lines.append(f"{self.name}_bucket{_fmt_labels(key, le)} {cum}")
            cum += rec[len(self.buckets)]
            inf = 'le="+Inf"'
            lines.append(f"{self.name}_bucket{_fmt_labels(key, inf)} {cum}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                         f"{_fmt_value(rec[-2])}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {rec[-1]}")
        return lines


class SeriesGauge(Metric):
    """A gauge whose value is a short per-slot SERIES — the in-scan
    device metrics a K-step superstep publishes once per dispatch
    (per-iteration loss / grad-norm / overflow). ``set_series`` stores
    the whole device array WITHOUT slicing or syncing (one lazy array,
    zero added dispatches on the hot path); elements materialize at
    read/exposition time only, exposed per-slot as
    ``name{slot="i"}``."""

    kind = "gauge"

    def set_series(self, values, **labels):
        """Store a 1-D array/list of per-slot values (device arrays
        stay lazy — ``tolist()`` happens only when read)."""
        self._values[_label_key(labels)] = values

    def series(self, **labels) -> list:
        """The stored series as plain floats (syncs a device array)."""
        v = self._values.get(_label_key(labels))
        if v is None:
            return []
        if hasattr(v, "tolist"):
            v = v.tolist()
        return [float(x) for x in v]

    def value(self, **labels) -> float:
        """Last slot of the series (the most recent iteration)."""
        s = self.series(**labels)
        return s[-1] if s else 0.0

    def total(self) -> float:
        return float(sum(sum(self.series(**dict(k)))
                         for k in list(self._values)))

    def expose(self) -> list:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        for key in sorted(self._values):
            for i, x in enumerate(self.series(**dict(key))):
                slot = f'slot="{i}"'
                lines.append(f"{self.name}{_fmt_labels(key, slot)} "
                             f"{_fmt_value(x)}")
        return lines


class MetricsRegistry:
    """Named collection of metrics; one process-global default instance
    lives in ``mxnet_tpu_torch.observability``."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
              "series_gauge": SeriesGauge}

    #: lock protocol, machine-checked by mxtpu-lint's thread-guard rule:
    #: registration mutates the name->metric map only under _lock (reads
    #: are deliberately lock-free — the GIL covers dict lookups, and the
    #: hot paths record without taking a lock).
    _GUARDED_BY = {"_metrics": "_lock"}

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise MXNetError(
                        f"metric {name} already registered as {m.kind}, "
                        f"requested {cls.kind}")
                return m
            m = cls(name, help, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name, help="") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help="") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def series_gauge(self, name, help="") -> SeriesGauge:
        return self._get_or_create(SeriesGauge, name, help)

    def get(self, name):
        return self._metrics.get(name)

    def metrics(self):
        return list(self._metrics.values())

    def reset(self):
        """Clear recorded values; metric definitions stay registered."""
        for m in self._metrics.values():
            m.clear()

    def dump_prometheus(self) -> str:
        """Prometheus text exposition format (one scrape body)."""
        lines = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].expose())
        return "\n".join(lines) + ("\n" if lines else "")
