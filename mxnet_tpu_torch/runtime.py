"""Runtime feature detection and retry with backoff (reference:
``python/mxnet/runtime.py`` + ``src/libinfo.cc``; the port's copy of
``mxnet_tpu/runtime.py``). ``Features`` reports what this process's
torch build and card offer (CUDA, cuDNN, NCCL); the JAX package's
persistent compilation cache has no counterpart here."""

from __future__ import annotations

import logging
import random
import time

import torch

_logger = logging.getLogger("mxnet_tpu_torch.runtime")

#: process-local RNG for retry jitter, seeded from OS entropy: every
#: process draws a different backoff sequence (never seed it from a
#: shared config value)
_RETRY_RNG = random.Random()


def backoff_delays(attempts, base_delay, max_delay=30.0, jitter=True,
                   rng=None):
    """The sleep schedule ``retry_with_backoff`` walks, ``attempts - 1``
    floats. With ``jitter`` it is decorrelated jitter, ``d_i =
    min(max_delay, uniform(base_delay, 3 * d_{i-1}))``; ``jitter=False``
    is the linear ramp ``base_delay * i``."""
    attempts = max(1, int(attempts))
    base_delay = float(base_delay)
    if not jitter:
        return [base_delay * i for i in range(1, attempts)]
    r = rng if rng is not None else _RETRY_RNG
    delays, prev = [], base_delay
    for _ in range(attempts - 1):
        prev = min(float(max_delay), r.uniform(base_delay, max(base_delay,
                                                               prev * 3.0)))
        delays.append(prev)
    return delays


def retry_with_backoff(fn, attempts=3, base_delay=2.0, desc="operation",
                       retry_on=(Exception,), no_retry=(), logger=None,
                       jitter=True, max_delay=30.0, rng=None,
                       sleep=time.sleep):
    """Call ``fn()`` up to ``attempts`` times with backoff between tries
    (:func:`backoff_delays`), logging each failure; re-raise the last
    exception when every attempt fails. Exception types in ``no_retry``
    surface at once."""
    log = logger or _logger
    attempts = max(1, int(attempts))
    delays = backoff_delays(attempts, base_delay, max_delay=max_delay,
                            jitter=jitter, rng=rng)
    last = None
    for i in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 - retry loop by design
            if no_retry and isinstance(e, no_retry):
                raise
            last = e
            log.warning("%s attempt %d/%d failed: %s: %s", desc, i,
                        attempts, type(e).__name__, str(e)[:300])
            if i < attempts:
                sleep(delays[i - 1])
    raise last


class Feature:
    def __init__(self, name, enabled):
        self.name = name
        self.enabled = enabled

    def __repr__(self):
        return f"[{'✔' if self.enabled else '✖'} {self.name}]"


def _has_pillow():
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


class Features(dict):
    """Queryable feature set (reference: ``mx.runtime.Features``): CUDA
    when a card is visible, cuDNN and NCCL when the torch build has them
    and a card is visible."""

    def __init__(self):
        cuda = torch.cuda.is_available()
        nccl = False
        if cuda and torch.distributed.is_available():
            nccl = torch.distributed.is_nccl_available()
        feats = {
            "CUDA": cuda,
            "CUDNN": cuda and torch.backends.cudnn.is_available(),
            "NCCL": nccl,
            "TPU": False,
            "XLA": False,
            "PJIT": False,
            "PALLAS": False,
            "MKLDNN": torch.backends.mkldnn.is_available(),
            "OPENCV": _has_pillow(),
            "DIST_KVSTORE": False,
            "INT64_TENSOR_SIZE": True,
            "COMPILE_CACHE": False,
            "INTROSPECTION": True,
            "SIGNAL_HANDLER": True,
            "F16C": True,
            "BF16": True,
        }
        super().__init__({k: Feature(k, v) for k, v in feats.items()})

    def is_enabled(self, name):
        return self[name.upper()].enabled


def feature_list():
    return list(Features().values())
