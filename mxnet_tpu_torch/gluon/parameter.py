"""Gluon Parameter / ParameterDict.

PyTorch counterpart of ``mxnet_tpu/gluon/parameter.py``: deferred
initialisation (a shape with 0 entries is completed at the first
forward), ``grad_req`` write/add/null, prefix naming. A parameter lives on
one or more contexts; each copy is an NDArray whose tensor is a leaf with
its own gradient buffer. Handles stay stable across updates: the optimizer
writes into the same tensors.
"""

from __future__ import annotations

import numpy as _np
import torch

from .. import initializer
from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray, _device, torch_dtype


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape is known."""


def _shape_known(shape):
    return shape is not None and all(s > 0 for s in shape)


def _contexts(ctx):
    if ctx is None:
        ctx = [current_context()]
    elif not isinstance(ctx, (list, tuple)):
        ctx = [ctx]
    return [Context(c) for c in ctx]


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, stype="default",
                 grad_stype="default"):
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self.grad_req = grad_req
        self._data = None  # {Context: NDArray}
        self._deferred_init = None  # (init, [Context], default_init)
        # storage types: only "default" (dense) is ported; the Trainer's
        # fused update declines others, as the JAX package's does
        self._stype = stype
        self._grad_stype = grad_stype

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self._shape}, "
                f"dtype={self.dtype})")

    # -- shape -----------------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        if len(self._shape) != len(new_shape) or any(
                s > 0 and u > 0 and s != u
                for s, u in zip(self._shape, new_shape)):
            raise MXNetError(f"Cannot change shape of {self.name} from "
                             f"{self._shape} to {new_shape}")
        # only unknown (0) entries are filled in
        self._shape = tuple(s if s > 0 else u
                            for s, u in zip(self._shape, new_shape))

    # -- initialisation -------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate on ``ctx`` (default: the current context, the first
        CUDA card) and run the initializer: the parameter's own ``init``
        first, else ``init``, else ``default_init`` (Uniform). With a
        shape still unknown and ``allow_deferred_init``, wait for the
        first forward."""
        if self._data is not None and not force_reinit:
            return
        default_init = default_init or initializer.Uniform()
        ctx = _contexts(ctx)
        if not _shape_known(self._shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(
                f"Cannot initialize Parameter {self.name} because it has "
                f"invalid shape {self._shape} and allow_deferred_init=False")
        self._init_impl(init, ctx, default_init)

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        init, ctx, default_init = self._deferred_init
        self._deferred_init = None
        self._init_impl(init, ctx, default_init)

    def _init_impl(self, init, ctx_list, default_init):
        used = self.init if self.init is not None else (init or default_init)
        used = initializer.create(used)
        data = {}
        for c in ctx_list:
            arr = NDArray(torch.zeros(self._shape,
                                      dtype=torch_dtype(self.dtype),
                                      device=_device(c)))
            used(self.name, arr)
            if self.grad_req != "null":
                arr.attach_grad(self.grad_req)
            data[c] = arr
        self._data = data

    # -- access ----------------------------------------------------------
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"Parameter {self.name} has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass.")
        raise MXNetError(
            f"Parameter {self.name} has not been initialized. You should "
            "initialize parameters and create a Trainer first.")

    def _resolve_ctx(self, ctx):
        if ctx is None:
            if len(self._data) == 1:
                return next(iter(self._data))
            ctx = current_context()
        ctx = Context(ctx)
        if ctx not in self._data:
            raise MXNetError(f"Parameter {self.name} was not initialized on "
                             f"context {ctx}; it is on {list(self._data)}")
        return ctx

    def data(self, ctx=None) -> NDArray:
        self._check_initialized()
        return self._data[self._resolve_ctx(ctx)]

    def list_data(self):
        self._check_initialized()
        return list(self._data.values())

    def grad(self, ctx=None) -> NDArray:
        self._check_initialized()
        if self.grad_req == "null":
            raise MXNetError(f"Parameter {self.name} has grad_req='null'")
        return self._data[self._resolve_ctx(ctx)].grad

    def list_grad(self):
        self._check_initialized()
        return [d.grad for d in self._data.values()]

    def set_data(self, data):
        """Overwrite every copy with ``data`` (an NDArray, tensor or numpy
        array of the parameter's shape), in place."""
        self.shape = tuple(data.shape)
        if self._data is None:
            if self._deferred_init is None:
                raise MXNetError(f"Parameter {self.name} not initialized")
            self._finish_deferred_init()
        src = data.data if isinstance(data, NDArray) else data
        if isinstance(src, _np.ndarray):
            src = torch.from_numpy(_np.array(src))
        with torch.no_grad():
            for arr in self._data.values():
                arr.data.copy_(src)

    def zero_grad(self):
        if self._data is None:
            return
        with torch.no_grad():
            for arr in self._data.values():
                if arr.grad is not None:
                    arr.grad.data.zero_()

    def cast(self, dtype):
        """Cast the data and the gradient buffer of every copy to
        ``dtype`` (a dtype name, numpy or torch dtype); a deferred
        parameter is created in it. The handles stay; their tensors are
        new, so a Trainer's fused plan rebuilds on its next step."""
        if isinstance(dtype, torch.dtype):
            dtype = str(dtype).split(".")[1]
        self.dtype = dtype if isinstance(dtype, str) \
            else _np.dtype(dtype).name
        if self._data is None:
            return
        dt = torch_dtype(self.dtype)
        for arr in self._data.values():
            arr._t = arr._t.detach().to(dt).requires_grad_(
                arr._t.requires_grad)
            if arr.grad is not None:
                arr.grad._t = arr.grad._t.to(dt)


class ParameterDict:
    """Prefix-scoped parameter dictionary (reference: ``ParameterDict``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, created with ``kwargs`` if it
        does not exist (or taken from the shared dict)."""
        name = self._prefix + name
        if name in self._params:
            param = self._params[name]
            if "shape" in kwargs and param.shape is not None:
                param.shape = kwargs["shape"]
            return param
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        param = self._params[name] = Parameter(name, **kwargs)
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"Parameter name {k} conflicts")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        del verbose
        for p in self._params.values():
            p.initialize(init=None, ctx=ctx,
                         default_init=init or initializer.Uniform(),
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()
