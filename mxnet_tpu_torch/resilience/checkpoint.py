"""Crash-safe file replacement.

The port's copy of ``atomic_replace`` and its sequence counter from
``mxnet_tpu/resilience/checkpoint.py``: a writer produces the content
under a temporary name unique to the call, which is fsynced and renamed
over the target, so a process stopped mid-write never leaves a truncated
file where the last good one was.
"""

from __future__ import annotations

import os
import threading

_TMP_SEQ = [0]  # per-process uniquifier for the temporary names
# re-entrant: a signal handler on the main thread may interrupt a frame
# already inside the lock
_TMP_SEQ_LOCK = threading.RLock()


def _next_seq():
    with _TMP_SEQ_LOCK:
        _TMP_SEQ[0] += 1
        return _TMP_SEQ[0]


def atomic_replace(path, write_fn):
    """``write_fn(tmp_path)`` produces the content, which is fsynced and
    renamed over ``path``; the temporary name is unique per call, so
    concurrent savers of one path never clobber each other's half-written
    file."""
    tmp = f"{path}.tmp{os.getpid()}-{_next_seq()}"
    try:
        write_fn(tmp)
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
