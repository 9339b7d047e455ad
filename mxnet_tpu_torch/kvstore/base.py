"""The KVStore interface and its registry (reference:
``mxnet_tpu/kvstore/base.py``). ``create`` takes every name of the
reference, whose legacy GPU-era names map onto the stores here: ``nccl``
onto ``device``, the ``dist*`` names and ``horovod`` onto
``dist_tpu_sync``."""

from __future__ import annotations

from ..base import MXNetError

_KV_REGISTRY = {}

#: legacy names -> the stores of this package (reference alias table)
_ALIASES = {
    "local_allreduce_cpu": "local",
    "local_allreduce_device": "device",
    "nccl": "device",
    "dist": "dist_tpu_sync",
    "dist_sync": "dist_tpu_sync",
    "dist_device_sync": "dist_tpu_sync",
    "dist_sync_device": "dist_tpu_sync",
    "dist_async": "dist_tpu_sync",
    "horovod": "dist_tpu_sync",
}


def register_kvstore(*names):
    """Class decorator: register a store under ``names``."""
    def deco(klass):
        for n in names:
            _KV_REGISTRY[n] = klass
        return klass

    return deco


class KVStoreBase:
    """The store interface (reference: ``KVStoreBase``)."""

    def init(self, key, value):
        raise NotImplementedError

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out=out, priority=priority)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise NotImplementedError

    def set_gradient_compression(self, compression_params):
        raise NotImplementedError

    def set_optimizer(self, optimizer):
        raise NotImplementedError

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise NotImplementedError

    def load_optimizer_states(self, fname):
        raise NotImplementedError

    def barrier(self):
        pass

    @staticmethod
    def is_capable(capability):
        return True


def create(name="local"):
    """A new store of type ``name`` (reference: ``mx.kv.create``); its
    ``type`` is the name asked for."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    key = _ALIASES.get(name, name)
    if key not in _KV_REGISTRY:
        raise MXNetError(f"unknown KVStore type {name}")
    store = _KV_REGISTRY[key]()
    store._type = name
    return store
