"""Gluon Block / HybridBlock.

PyTorch counterpart of ``mxnet_tpu/gluon/block.py``: name scopes with
per-scope counters, so ``collect_params()`` keys equal the JAX package's
(``bertmodel0_encoder_cells_transformer0_attn_query_weight``), child
registration, ``initialize``, shape inference at the first call for
deferred parameters, and ``__call__`` -> ``hybrid_forward(F, x,
**params)`` with ``F`` the ``nd`` namespace.

``hybridize()`` is accepted and changes nothing: a HybridBlock always runs
its eager path here. The JAX package traces the forward into one compiled
executable (``_CachedGraph``); its counterpart on the card, a captured
CUDA graph, is not ported yet.
"""

from __future__ import annotations

import threading

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict


class _NameManager(threading.local):
    """Global per-hint counters for blocks made outside any name scope
    (reference: ``mxnet/name.py``)."""

    def __init__(self):
        self.counter = {}

    def next_prefix(self, hint):
        count = self.counter.get(hint, 0)
        self.counter[hint] = count + 1
        return f"{hint}{count}_"


_NAMES = _NameManager()


def reset_names():
    """Restart the global counters (``bertmodel0_`` comes next again)."""
    _NAMES.counter.clear()


class _BlockScope:
    """Name scoping for automatic prefixes (reference: ``_BlockScope``)."""

    _state = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def current():
        return getattr(_BlockScope._state, "scope", None)

    @staticmethod
    def create(prefix, params, hint):
        current = _BlockScope.current()
        if current is None:
            if prefix is None:
                prefix = _NAMES.next_prefix(hint)
            params = ParameterDict(prefix) if params is None \
                else ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = _BlockScope.current()
        _BlockScope._state.scope = self
        return self

    def __exit__(self, *exc):
        if not self._block._empty_prefix:
            _BlockScope._state.scope = self._old_scope
        return False


class Block:
    """Base model-building block (reference: ``gluon.Block``)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter) and hasattr(self, "_reg_params"):
            self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return self._scope

    def collect_params(self) -> ParameterDict:
        """This block's and its children's parameters, keyed by full
        name."""
        ret = ParameterDict(self._params.prefix)
        ret.update(self.params)
        for child in self._children.values():
            ret.update(child.collect_params())
        return ret

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialise every parameter on ``ctx``: the first CUDA card by
        default (MXNet's default was the CPU); pass ``ctx=mx.cpu()`` for
        the host."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Accepted for API parity; blocks keep running eagerly (no graph
        capture yet)."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter of this block and its children to
        ``dtype`` (reference: ``Block.cast``)."""
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def zero_grad(self):
        self.collect_params().zero_grad()

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Block written as ``hybrid_forward(F, x, *args, **params)``, where
    ``F`` is the ``nd`` namespace and ``params`` this block's registered
    parameters on the input's context."""

    def infer_shape(self, *args):
        """Set shapes of this block's deferred parameters from its inputs;
        built-in layers override it."""
        raise MXNetError(
            f"{self.__class__.__name__} has deferred-initialization "
            "parameters but does not implement infer_shape(); specify "
            "in_units/in_channels or override infer_shape().")

    def _resolve_params(self, args):
        ctx = next((a.context for a in args if isinstance(a, NDArray)),
                   None)
        kwargs = {}
        for name, p in self._reg_params.items():
            try:
                kwargs[name] = p.data(ctx)
            except DeferredInitializationError:
                self.infer_shape(*[a for a in args if isinstance(a, NDArray)])
                for q in self._reg_params.values():
                    q._finish_deferred_init()
                kwargs[name] = p.data(ctx)
        return kwargs

    def forward(self, *args, **kwargs):
        from .. import ndarray as F

        params = self._resolve_params(args)
        return self.hybrid_forward(F, *args, **kwargs, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def optimize_for(self, x=None, backend="tpu_fused_conv_bn", strict=True,
                     **kwargs):
        """Apply a backend optimisation pass (reference:
        ``HybridBlock.optimize_for(x, backend='MKLDNN')``, the conv+BN
        subgraph fusion). The ``"tpu_fused_conv_bn"`` backend switches the
        interior to NHWC with fused 1x1-conv + BN-statistics kernels and
        RETURNS an adapter keeping the NCHW interface (see
        ``gluon/nn/tpu_fusion.py``). ``x`` (a sample input) is accepted for
        API parity and unused."""
        del x, kwargs
        from .nn.tpu_fusion import optimize_for as _opt

        return _opt(self, backend=backend, strict=strict)
