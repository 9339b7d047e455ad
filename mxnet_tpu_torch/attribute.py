"""Symbol attribute scoping (reference: ``python/mxnet/attribute.py``;
the port's copy of ``mxnet_tpu/attribute.py``). ``AttrScope(ctx_group=
...)`` was the reference's model-parallel placement hook; the scope's
attributes are kept for the symbol front end (ROADMAP A13)."""

from __future__ import annotations

import threading


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        self._attr = kwargs

    def get(self, attr=None):
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = getattr(AttrScope._current, "value", None)
        attr = {} if self._old_scope is None else dict(self._old_scope._attr)
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, *exc):
        AttrScope._current.value = self._old_scope
        return False

    @staticmethod
    def current():
        cur = getattr(AttrScope._current, "value", None)
        return cur if cur is not None else AttrScope()
