"""Telemetry seam of the port: off.

The JAX package guards every metric update in the serving code and the
cached graph with ``if _obs.ENABLED:``. The port keeps those guarded
sites, with the JAX package's metric names, so that the port of
``mxnet_tpu/observability/`` (the metrics registry and its names) can be
dropped in behind them: in ``gluon/block.py``, ``CACHEDOP_CACHE_HITS``
(``mxtpu_cachedop_cache_hit_total``), ``record_compile`` (which counts
``mxtpu_cachedop_compile_total``, ``mxtpu_cachedop_trace_seconds_total``
and, with a cause, ``mxtpu_cachedop_retrace_total``) and
``SHAPE_WOBBLE_TOTAL`` (``mxtpu_shape_wobble_total``). Until then nothing
turns telemetry on.
"""

from __future__ import annotations

ENABLED = False
