"""The streaming shard reader (reference: ``mxnet_tpu/gluon/data/
stream.py``: ``ShardIndex``, ``ShardSet``, ``GlobalOrder``,
``StreamReader``, ``device_augment``, ``write_recordio_shards``). It is
ROADMAP A13's; every name raises until then."""

from __future__ import annotations

from ...base import MXNetError

_NAMES = ("ShardIndex", "ShardSet", "GlobalOrder", "StreamReader",
          "device_augment", "write_recordio_shards")


def _unported(name):
    def raise_a13(*args, **kwargs):
        raise MXNetError(f"gluon.data.{name}: the streaming shard reader "
                         "is not in the port yet (ROADMAP A13)")

    raise_a13.__name__ = name
    return raise_a13


for _name in _NAMES:
    globals()[_name] = _unported(_name)
