"""Global name manager for automatic block/symbol prefixes.

Reference: ``python/mxnet/name.py`` (``NameManager``); the port's copy of
``mxnet_tpu/name.py``.
"""

from __future__ import annotations

import threading


class NameManager(threading.local):
    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name is not None:
            return name
        count = self._counter.get(hint, 0)
        self._counter[hint] = count + 1
        return f"{hint}{count}"


_MANAGER = NameManager()


def next_prefix(hint: str) -> str:
    return _MANAGER.get(None, hint) + "_"


def next_name(hint: str) -> str:
    return _MANAGER.get(None, hint)


def reset():
    _MANAGER._counter.clear()
