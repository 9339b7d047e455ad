"""Operator registry.

PyTorch counterpart of ``mxnet_tpu/ops/registry.py`` (the nnvm op
registry of reference MXNet, whose Python stubs were generated at import
time). An op is a plain function of tensors, ``fn(*arrays, **attrs)``,
with its attributes as keywords; the ``nd`` namespace, the NDArray
methods and ``ops.dispatch.invoke`` are generated from this registry.
There is no executable cache: torch runs an op eagerly, and a hybridized
block captures a CUDA graph of a whole forward (``gluon/_capture.py``).
The AMP cast policy that the JAX package applies here is applied where
an op is dispatched (``ops/dispatch.py``, ``amp/policy.py``).
"""

from __future__ import annotations

_OPS: dict = {}


class OpDef:
    __slots__ = ("fn", "name", "aliases", "as_method")

    def __init__(self, fn, name, aliases=(), as_method=None):
        self.fn = fn
        self.name = name
        self.aliases = aliases
        self.as_method = as_method  # attach to NDArray under this name

    def __repr__(self):
        return f"<op {self.name}>"

    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return self is other


def register(name=None, aliases=(), as_method=None):
    """Register an op implementation ``fn(*tensors, **attrs)`` under
    ``name`` (its own name by default) and each of ``aliases``."""

    def deco(fn):
        opname = name or fn.__name__
        opdef = OpDef(fn, opname, tuple(aliases), as_method)
        _OPS[opname] = opdef
        for a in aliases:
            _OPS[a] = opdef
        return fn

    return deco


def get(name: str) -> OpDef:
    return _OPS[name]


def all_ops() -> dict:
    return _OPS
