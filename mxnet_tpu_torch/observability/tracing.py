"""Low-overhead event tracer: step-scoped spans in a ring buffer.

PyTorch counterpart of ``mxnet_tpu/observability/tracing.py`` (host code:
the same classes, names and output).

Reference analog: MXNet's engine-integrated profiler dumping
chrome://tracing JSON (``src/profiler/profiler.cc::DumpProfile``). Here
events are plain dicts appended to a bounded ``deque`` (capacity
``MXTPU_TRACE_BUFFER``, default 65536 — old events fall off rather than
grow memory on long runs) and export two ways:

- ``dump_chrome_trace()`` — the ``{"traceEvents": [...]}`` JSON that
  chrome://tracing / Perfetto load directly,
- ``dump_jsonl()`` — one event object per line, the format
  ``tools/telemetry_report.py`` aggregates.

Timestamps are microseconds on the ``perf_counter`` clock, zeroed at
tracer construction (chrome://tracing only needs monotonicity).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time

from ..base import getenv


def _default_capacity() -> int:
    return getenv("MXTPU_TRACE_BUFFER", 65536, dtype=int)


class Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer.record(self.name, cat=self.cat,
                            ts=self._t0, dur=t1 - self._t0, args=self.args)
        return False


class Tracer:
    """Ring buffer of trace events."""

    def __init__(self, capacity=None):
        self._events = collections.deque(
            maxlen=capacity or _default_capacity())
        self._epoch = time.perf_counter()
        self.step = 0  # advanced by Trainer.step via mark_step()
        # span ids: process-unique, monotonic, survive clear() — parent
        # links recorded before a clear must not collide after it
        self._span_ids = itertools.count(1)

    # -- recording -------------------------------------------------------
    def mark_step(self) -> int:
        """Advance the step counter; spans recorded afterwards carry the
        new step id in their args."""
        self.step += 1
        return self.step

    def new_span_id(self) -> int:
        """A process-unique span id (itertools.count — GIL-atomic).
        Correlated child events reference it via ``args["parent"]``."""
        return next(self._span_ids)

    def record(self, name, cat="default", ts=None, dur=0.0, args=None,
               ph="X", span_id=None):
        """Append one event. ``ts``/``dur`` are perf_counter seconds
        (``ts=None`` means now). Every event carries a unique ``id``
        (pass ``span_id`` to stamp one minted earlier, e.g. before
        handing it to children as their parent)."""
        if ts is None:
            ts = time.perf_counter()
        ev = {
            "name": name,
            "cat": cat,
            "ph": ph,
            "id": int(span_id) if span_id is not None else self.new_span_id(),
            "ts": (ts - self._epoch) * 1e6,
            "dur": dur * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFF,
            "args": dict(args or (), step=self.step),
        }
        self._events.append(ev)
        return ev

    def instant(self, name, cat="default", **args):
        return self.record(name, cat=cat, dur=0.0, args=args, ph="i")

    def span(self, name, cat="default", **args) -> Span:
        return Span(self, name, cat, args)

    # -- read side -------------------------------------------------------
    def events(self) -> list:
        return list(self._events)

    def __len__(self):
        return len(self._events)

    def clear(self):
        self._events.clear()
        self.step = 0

    # -- exporters -------------------------------------------------------
    def dump_chrome_trace(self, path=None) -> str:
        """chrome://tracing JSON; written to ``path`` when given."""
        # default=float: event args may hold asynchronous device scalars
        # (the fused step's lazy grad norm) — sync them at dump time only
        body = json.dumps({"traceEvents": self.events(),
                           "displayTimeUnit": "ms"}, default=float)
        if path:
            with open(path, "w") as f:
                f.write(body)
        return body

    def dump_jsonl(self, path=None) -> str:
        """One JSON event per line; written to ``path`` when given."""
        body = "\n".join(json.dumps(ev, default=float)
                         for ev in self._events)
        if body:
            body += "\n"
        if path:
            with open(path, "w") as f:
                f.write(body)
        return body


def load_jsonl(source) -> list:
    """Parse a JSONL trace from a path or a string body."""
    if "\n" not in source and os.path.exists(source):
        with open(source) as f:
            text = f.read()
    else:
        text = source
    return [json.loads(line) for line in text.splitlines() if line.strip()]
