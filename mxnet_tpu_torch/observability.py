"""Telemetry seam of the port: off.

The JAX package guards every metric update in the serving code with
``if _obs.ENABLED:``. The port keeps those guarded sites, with the JAX
package's metric names, so that the port of ``mxnet_tpu/observability/``
(the metrics registry and its names) can be dropped in behind them. Until
then nothing turns telemetry on.
"""

from __future__ import annotations

ENABLED = False
