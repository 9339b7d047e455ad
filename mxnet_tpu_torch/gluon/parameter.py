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
from ..ndarray.ndarray import NDArray, _check_held, _device, array, torch_dtype


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape is known."""


def _shape_known(shape):
    return shape is not None and all(s > 0 for s in shape)


def _dtype_name(dtype):
    """``"float32"`` for a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[1]
    return dtype if isinstance(dtype, str) else _np.dtype(dtype).name


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
                                      device=_device(c)), c)
            used(self.name, arr)
            if self.grad_req != "null":
                arr.attach_grad(self.grad_req)
            data[c] = arr
        self._data = data

    def _load_init(self, data, ctx=None, cast_dtype=False,
                   dtype_source="current"):
        """Load from a saved array (an NDArray or a tensor; reference:
        ``Parameter._load_init``). A known shape must match. With
        ``cast_dtype`` and ``dtype_source="current"`` the data is cast to
        the parameter's dtype; otherwise the parameter takes the saved
        dtype's name, as the JAX package does. A parameter that already
        holds tensors is written in place (converted to each tensor's
        type), so its handles keep their tensors and a captured graph or
        a Trainer's plan over them stays valid; one that does not is
        created from the data on ``ctx`` (default: the contexts it was
        initialised or deferred on), ending a deferred initialisation."""
        t = data.data if isinstance(data, NDArray) else data
        if _shape_known(self._shape):
            if tuple(t.shape) != tuple(self._shape):
                raise MXNetError(
                    f"Failed loading Parameter {self.name}: shape mismatch "
                    f"saved {tuple(t.shape)} vs expected {self._shape}")
        else:
            self._shape = tuple(t.shape)
        if cast_dtype and dtype_source == "current":
            t = t.to(torch_dtype(self.dtype))
        else:
            self.dtype = _dtype_name(t.dtype)
        if ctx is None:
            ctx = list(self._data) if self._data is not None else (
                self._deferred_init[1] if self._deferred_init is not None
                else None)
        ctx = _contexts(ctx)
        self._deferred_init = None
        t = t.detach()
        with torch.no_grad():
            if self._data is not None:
                for arr in self._data.values():
                    arr.data.copy_(t)
                return
            data = {}
            for c in ctx:
                arr = NDArray(t.to(_device(c), copy=True), c)
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

    def list_ctx(self):
        """The contexts the parameter lives on (or is deferred to)."""
        if self._data is None and self._deferred_init is not None:
            return self._deferred_init[1]
        self._check_initialized()
        return list(self._data)

    def reset_ctx(self, ctx):
        """Move the parameter to ``ctx`` (a context or a list): new
        handles holding the current values; a deferred parameter is
        deferred to ``ctx`` instead."""
        ctx = _contexts(ctx)
        if self._data is not None:
            host = next(iter(self._data.values())).data.detach()
            self._data = None
            self._load_init(host, ctx)
        elif self._deferred_init is not None:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)

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
                _check_held(arr.data)
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


class Constant(Parameter):
    """Non-differentiable constant parameter (reference:
    ``gluon.Constant``); ``value`` is an NDArray, a tensor or an array
    on the host."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = NDArray(value.detach().cpu()) if isinstance(
                value, torch.Tensor) else array(value, ctx=Context("cpu"))
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=_dtype_name(value.data.dtype),
                         init=_ConstantInit(value))


class _ConstantInit(initializer.Initializer):
    """Writes the constant's value (by name suffix as every initializer
    dispatches, so only weight-like names take it, as in the JAX
    package)."""

    def __init__(self, value):
        super().__init__()
        self.value = value

    def _init_weight(self, _, arr):
        with torch.no_grad():
            arr.data.copy_(self.value.data)


class ParameterDict:
    """Prefix-scoped parameter dictionary (reference: ``ParameterDict``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        s = "\n".join(repr(p) for p in self._params.values())
        return f"{self._prefix}(\n{s}\n)"

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

    def get_constant(self, name, value=None):
        """The constant ``prefix + name``, created from ``value`` if it
        does not exist."""
        name = self._prefix + name
        if name in self._params:
            return self._params[name]
        if value is None:
            raise MXNetError(f"No constant named {name}")
        c = self._params[name] = Constant(name, value)
        return c

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

    def reset_ctx(self, ctx):
        for p in self._params.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set attribute ``name`` (``grad_req``, ``lr_mult``, ...) of
        every parameter."""
        for p in self._params.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Save every parameter's data under its full name, less
        ``strip_prefix``, in the NDARRAY_V2 container."""
        from ..ndarray import ndarray as nd

        arg_dict = {}
        for param in self._params.values():
            name = param.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = param.list_data()[0]
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="", cast_dtype=False,
             dtype_source="current"):
        """Load a file of full names (``arg:``/``aux:`` prefixes dropped,
        ``restore_prefix`` put in front) into the parameters."""
        from ..ndarray.ndarray import _load_host

        loaded = _load_host(filename)
        loaded = {restore_prefix + k.replace("arg:", "").replace("aux:", ""):
                  v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise MXNetError(
                        f"Parameter {name} missing in file {filename}")
        for name, data in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        f"Parameter {name} in file but not in dict")
                continue
            self._params[name]._load_init(data, ctx, cast_dtype=cast_dtype,
                                          dtype_source=dtype_source)
