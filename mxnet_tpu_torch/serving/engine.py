"""Serving-engine knobs shared by the engines of the port.

PyTorch counterpart of ``mxnet_tpu/serving/engine.py``. Only the queue
bound that :class:`~.generation.GenerationEngine` reads is here so far;
the one-shot ``InferenceEngine`` and its batcher come with a later slice.
"""

from __future__ import annotations

from ..base import getenv

_QUEUE_DEFAULT = 256


def serve_queue_cap() -> int:
    """Bounded submit-queue depth (requests) before load shedding,
    ``MXTPU_SERVE_QUEUE``."""
    return max(1, int(getenv("MXTPU_SERVE_QUEUE", _QUEUE_DEFAULT,
                             dtype=int)))
