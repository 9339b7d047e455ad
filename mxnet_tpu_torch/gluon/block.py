"""Gluon Block / HybridBlock.

PyTorch counterpart of ``mxnet_tpu/gluon/block.py``: name scopes with
per-scope counters, so ``collect_params()`` keys equal the JAX package's
(``bertmodel0_encoder_cells_transformer0_attn_query_weight``), child
registration, ``initialize``, shape inference at the first call for
deferred parameters, ``__call__`` -> ``hybrid_forward(F, x, **params)``
with ``F`` the ``nd`` namespace, and ``hybridize()``.

``hybridize()`` routes a HybridBlock's calls through its
:class:`_CachedGraph`, the counterpart of the JAX package's CachedOp
(one compiled forward and backward per input signature). On a CUDA card
each signature's entry captures the block's forward, and for a call
under ``autograd.record()`` its backward, as CUDA graphs
(``gluon/_capture.py``) and replays them: one host call for a whole
forward or backward instead of one per operator. On the CPU the same
entry runs both halves eagerly, so the key, the gradient routing and the
write-back of auxiliary state are the same code on both.

``save_parameters``/``load_parameters`` write and read the NDARRAY_V2
``.params`` container keyed by the structural names of
``_collect_params_with_prefix`` (``encoder.transformer_cells.0.ln1.gamma``),
the same keys and bytes as the JAX package, so a file either package
writes loads in the other.
"""

from __future__ import annotations

import contextlib
import logging
import re
import threading
import time
import weakref

import torch

from .. import autograd
from .. import fusedstep as _fusedstep
from .. import observability as _obs
from ..amp import policy as _amp_policy
from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray, zeros
from . import _capture
from .parameter import DeferredInitializationError, Parameter, ParameterDict

_logger = logging.getLogger(__name__)


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
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        self._forward_hooks = []
        self._forward_pre_hooks = []

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join(
            f"  ({key}): {_indent(repr(block), 2)}"
            for key, block in self._children.items())
        return s.format(name=self.__class__.__name__, modstr=modstr)

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
    def name(self):
        return self._name

    @property
    def params(self):
        return self._params

    def name_scope(self):
        return self._scope

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and its children's parameters, keyed by full
        name; ``select``, a regular expression, keeps the names it
        matches (``re.match``)."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self.params.items()
                        if pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after each call; returns a handle
        whose ``detach()`` removes it. Inside a hybridized block's cached
        graph a child's hooks run when an entry is built, not on its
        replays, as they run at trace time in the JAX package."""
        self._forward_hooks.append(hook)
        return _HookHandle(self._forward_hooks, hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each call (see
        :meth:`register_forward_hook`)."""
        self._forward_pre_hooks.append(hook)
        return _HookHandle(self._forward_pre_hooks, hook)

    def apply(self, fn):
        """``fn(block)`` on every child, depth first, then on this
        block; returns this block."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialise every parameter on ``ctx``: the first CUDA card by
        default (MXNet's default was the CPU); pass ``ctx=mx.cpu()`` for
        the host."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Hybridize (or, with ``active=False``, un-hybridize) every
        HybridBlock among the children; a plain Block itself runs
        eagerly."""
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

    def reset_ctx(self, ctx):
        """Move every parameter to ``ctx`` (new handles)."""
        self.collect_params().reset_ctx(ctx)

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters keyed by their structural names: the attribute
        names of the registered parameters, behind the children's
        registration names (attribute names, or ``"0"``, ``"1"``, ... for
        ``add``), joined by dots: the keys of a ``.params`` file."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter's data to ``filename`` in the NDARRAY_V2
        container, keyed by structural name, from the host; committed
        through ``resilience.checkpoint.atomic_replace``, so a process
        stopped mid-write leaves the previous file whole."""
        del deduplicate
        from ..ndarray import ndarray as nd
        from ..resilience.checkpoint import atomic_replace

        params = self._collect_params_with_prefix()
        arrays = {}
        for k, p in params.items():
            p._check_initialized()
            arrays[k] = next(iter(p._data.values()))
        atomic_replace(filename, lambda tmp: nd.save(tmp, arrays))

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a ``.params`` file written by :meth:`save_parameters` (of
        either package). A parameter that holds tensors is written in
        place (``Parameter._load_init``); a file of full parameter names
        goes through ``collect_params().load`` with this block's prefix
        restored, as in the JAX package."""
        from ..ndarray.ndarray import _load_host

        loaded = _load_host(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        # legacy full-prefix format fallback
        if loaded and (not params or (
                next(iter(loaded)) not in params
                and next(iter(loaded)) in self.collect_params().keys())):
            self.collect_params().load(
                filename, ctx, allow_missing, ignore_extra, self.prefix,
                cast_dtype=cast_dtype, dtype_source=dtype_source)
            return
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError(
                        f"Parameter {name} is missing in file {filename}")
        for name in loaded:
            if name not in params:
                if not ignore_extra:
                    raise MXNetError(
                        f"Parameter {name} loaded from file {filename} is "
                        "not present in the Block")
                continue
            params[name]._load_init(loaded[name], ctx, cast_dtype=cast_dtype,
                                    dtype_source=dtype_source)

    def save(self, prefix):
        self.save_parameters(prefix + "-model.params")

    def __call__(self, *args, **kwargs):
        fire = not getattr(_TRACE_STATE, "mute_hooks", False)
        if fire:
            for hook in self._forward_pre_hooks:
                hook(self, args)
        out = self.forward(*args, **kwargs)
        if fire:
            for hook in self._forward_hooks:
                hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print (and return) a table of every block, indented by depth,
        with the number of elements of the parameters it owns."""
        del inputs
        summary = []

        def walk(block, depth):
            n_params = 0
            for p in block.params.values():
                if p.shape and all(s > 0 for s in p.shape):
                    n = 1
                    for s in p.shape:
                        n *= s
                    n_params += n
            summary.append(("  " * depth + block.__class__.__name__,
                            n_params))
            for c in block._children.values():
                walk(c, depth + 1)

        walk(self, 0)
        lines = ["-" * 50, f"{'Layer':<38}{'Params':>12}", "=" * 50]
        total = 0
        for name, n in summary:
            lines.append(f"{name:<38}{n:>12}")
            total += n
        lines += ["=" * 50, f"Total params: {total}", "-" * 50]
        out = "\n".join(lines)
        print(out)
        return out


class _HookHandle:
    def __init__(self, hooks, hook):
        self._hooks, self._hook = hooks, hook

    def detach(self):
        if self._hook in self._hooks:
            self._hooks.remove(self._hook)


def _indent(s, num):
    return ("\n" + " " * num).join(s.split("\n"))


class HybridBlock(Block):
    """Block written as ``hybrid_forward(F, x, *args, **params)``, where
    ``F`` is the ``nd`` namespace and ``params`` this block's registered
    parameters on the input's context. After :meth:`hybridize` its calls
    go through its cached graph."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_graph = None
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=2, forward_bulk_size=None,
                  backward_bulk_size=None):
        """Route this block's calls through its cached graph (``active``)
        and drop every entry captured so far. Children are marked too; they
        run eagerly inside this block's capture. The flags are recorded
        and change nothing: as in the JAX package, which always compiles,
        a hybridized block always captures on a CUDA card. A capture reads
        the settings of its time (an operator swapped for another,
        ``MXTPU_FLASH_BWD``, the TF32 switches): call ``hybridize()``
        again after changing one."""
        del inline_limit, forward_bulk_size, backward_bulk_size
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape)
        self._cached_graph = None
        Block.hybridize(self, active)

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
        if self._active and not kwargs and not _in_cached_trace():
            return self._call_cached(*args)
        return self._eager_forward(*args, **kwargs)

    def _eager_forward(self, *args, **kwargs):
        from .. import ndarray as F

        params = self._resolve_params(args)
        return self.hybrid_forward(F, *args, **kwargs, **params)

    def _call_cached(self, *args):
        if self._cached_graph is None:
            self._cached_graph = _CachedGraph(self)
        return self._cached_graph(args)

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

    def warmup(self, shapes, dtype="float32", ctx=None, loss_fn=None,
               trainer=None, label_shape=None, label_dtype="float32"):
        """Build this block's cached-graph entries for a declared set of
        input shapes, so that the first real step (or request) replays.

        ``shapes``: one full input shape (batch dimension included) or a
        list of them. With only ``shapes`` the predict-mode forward runs
        once per shape. With ``loss_fn`` the recording forward and
        backward run (``loss_fn(out, label)`` on zero inputs and zero
        labels of ``label_shape``, default ``(batch,)``), and with
        ``trainer`` also ``trainer.step``. The weights, the gradient
        buffers, the optimizer's states and update counts and the random
        generators' states are put back afterwards, in place: every
        parameter handle keeps its tensor, so the entries built here stay
        valid. Returns the number of shapes run."""
        if isinstance(shapes, (tuple, list)) and shapes and \
                not isinstance(shapes[0], (tuple, list)):
            shapes = [tuple(shapes)]  # one bare shape, tuple or list
        ctx = ctx or current_context()
        if trainer is not None and loss_fn is None:
            raise MXNetError("warmup(trainer=...) requires loss_fn")
        params = [p for _, p in sorted(self.collect_params().items())]
        if any(p._data is None for p in params):
            # resolve deferred shapes with one eager predict pass
            with autograd.predict_mode():
                self(zeros(tuple(shapes[0]), ctx, dtype))
            params = [p for _, p in sorted(self.collect_params().items())]
        rng = _rng_state()
        saved = _snapshot_training_state(params, trainer) \
            if loss_fn is not None else None
        try:
            for shape in shapes:
                x = zeros(tuple(shape), ctx, dtype)
                if loss_fn is None:
                    with autograd.predict_mode():
                        out = self(x)
                    outs = out if isinstance(out, (list, tuple)) else [out]
                    for o in outs:
                        o.wait_to_read()
                    continue
                lshape = tuple(label_shape) if label_shape is not None \
                    else (int(shape[0]),)
                y = zeros(lshape, ctx, label_dtype)
                with autograd.record():
                    loss = loss_fn(self(x), y)
                loss.backward()
                if trainer is not None:
                    trainer.step(int(shape[0]))
                loss.wait_to_read()
            return len(shapes)
        finally:
            if saved is not None:
                _restore_training_state(params, trainer, saved)
            _set_rng_state(rng)

    def aot_predict_fn(self, ctx=None, dtype="float32", sample_shape=None):
        """This block's predict-mode forward as a function of its
        parameters: returns ``(fn, param_tensors)`` where
        ``fn(param_tensors, x)`` runs the forward with the parameter
        handles bound to ``param_tensors`` (the current parameters'
        tensors, in sorted-name order, by default) and returns the output
        tensor (a tuple for several outputs).

        ``fn`` records nothing (``torch.no_grad()``, predict mode: dropout
        off, BatchNorm on its running statistics), runs nested hybridized
        blocks eagerly (it never touches a cached graph), puts every
        handle back when it returns or raises, and draws any random
        number from the CPU generator seeded 0 (and from the card's,
        seeded 0, outside a capture). It can be captured as it stands into
        a CUDA graph (``gluon._capture.Graph``), one per input shape, with
        a static input buffer. ``sample_shape`` (batch dimension
        included) resolves deferred shapes with one eager pass."""
        ctx = ctx or current_context()
        params = [p for _, p in sorted(self.collect_params().items())]
        if sample_shape is not None and any(p._data is None for p in params):
            with autograd.predict_mode():
                self(zeros(tuple(sample_shape), ctx, dtype))
            params = [p for _, p in sorted(self.collect_params().items())]
        handles = [p.data(ctx) for p in params]

        def fn(param_tensors, x):
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(x, device=handles[0].data.device
                                    if handles else None)
            with torch.no_grad(), _fixed_rng(x.device), \
                    _bound(handles, param_tensors), \
                    autograd._RecordingStateScope(False, False):
                outs = self._eager_forward(NDArray(x))
            if isinstance(outs, NDArray):
                return outs._t
            return tuple(o._t for o in outs)

        return fn, [h.data for h in handles]

    def export(self, path, epoch=0):
        """Not in the port yet: ``export`` traces ``hybrid_forward`` with
        symbols, and the port has no ``symbol/`` layer (ROADMAP A13)."""
        raise MXNetError(
            f"{self.__class__.__name__}.export({path!r}, {epoch}) needs the "
            "symbol/ layer (symbol JSON + .params, ROADMAP A13), which the "
            "port does not have yet; save_parameters writes the weights")


# ---------------------------------------------------------------------------
# the cached graph
# ---------------------------------------------------------------------------

_TRACE_STATE = threading.local()  # .active: inside a cached graph's run


def _in_cached_trace():
    return getattr(_TRACE_STATE, "active", False)


@contextlib.contextmanager
def _bound(handles=(), tensors=()):
    """Run a forward as part of an enclosing capture or step: nested
    hybridized blocks run eagerly (``_in_cached_trace``), and each of
    ``handles`` holds the matching tensor of ``tensors`` until the end,
    when every handle gets its own tensor back."""
    prev = _in_cached_trace()
    saved = [h._t for h in handles]
    _TRACE_STATE.active = True
    try:
        for h, t in zip(handles, tensors):
            h._t = t
        yield
    finally:
        for h, t in zip(handles, saved):
            h._t = t
        _TRACE_STATE.active = prev


def signature_causes(old_sig, new_sig):
    """Why an input signature changed: diff two ``((shape, dtype), ...)``
    tuples into cause labels (``arity`` / ``shape`` / ``dtype``), named as
    the JAX package names them."""
    causes = []
    if old_sig != new_sig:
        if len(old_sig) != len(new_sig):
            causes.append("arity")
        else:
            if any(o[0] != n[0] for o, n in zip(old_sig, new_sig)):
                causes.append("shape")
            if any(o[1] != n[1] for o, n in zip(old_sig, new_sig)):
                causes.append("dtype")
    return causes


def _block_name(block):
    return getattr(block, "_name", block.__class__.__name__)


def _rng_state():
    """The default generators' states: the CPU's, and the current card's
    once CUDA is in use."""
    return (torch.get_rng_state(),
            torch.cuda.get_rng_state() if torch.cuda.is_initialized()
            else None)


@contextlib.contextmanager
def _rng_restored(state):
    """Inside: the default generators start from ``state``; after, they
    are as before."""
    cpu, cuda = state
    with torch.random.fork_rng(
            devices=[torch.cuda.current_device()] if cuda is not None
            else []):
        torch.set_rng_state(cpu)
        if cuda is not None:
            torch.cuda.set_rng_state(cuda)
        yield


def _set_rng_state(state):
    """Put the default generators back to ``state`` (from
    :func:`_rng_state`)."""
    cpu, cuda = state
    torch.set_rng_state(cpu)
    if cuda is not None:
        torch.cuda.set_rng_state(cuda)


@contextlib.contextmanager
def _fixed_rng(device):
    """Inside: the CPU generator (and, outside a CUDA-graph capture, the
    card's) starts from seed 0; after, both are as before."""
    cuda = device.type == "cuda" and \
        not torch.cuda.is_current_stream_capturing()
    with torch.random.fork_rng(devices=[device] if cuda else []):
        torch.default_generator.manual_seed(0)
        if cuda:
            torch.cuda.default_generators[
                device.index if device.index is not None
                else torch.cuda.current_device()].manual_seed(0)
        yield


@contextlib.contextmanager
def _hooks_muted(muted=True):
    """Inside (when ``muted``): blocks called skip their forward hooks,
    as an entry's replays and re-runs do."""
    prev = getattr(_TRACE_STATE, "mute_hooks", False)
    _TRACE_STATE.mute_hooks = muted or prev
    try:
        yield
    finally:
        _TRACE_STATE.mute_hooks = prev


def _copy_opt_state(st):
    if isinstance(st, (list, tuple)):
        return type(st)(_copy_opt_state(s) for s in st)
    if isinstance(st, NDArray):
        return NDArray(st.data.detach().clone())
    if isinstance(st, torch.Tensor):
        return st.detach().clone()
    return st


def _put_back_opt_state(st, saved):
    """Write ``saved`` (from :func:`_copy_opt_state`) into ``st`` in
    place; False when their structures differ."""
    if isinstance(st, (list, tuple)):
        return isinstance(saved, (list, tuple)) and len(st) == len(saved) \
            and all([_put_back_opt_state(a, b) for a, b in zip(st, saved)])
    t = st.data if isinstance(st, NDArray) else st
    v = saved.data if isinstance(saved, NDArray) else saved
    if isinstance(t, torch.Tensor):
        if not isinstance(v, torch.Tensor) or t.shape != v.shape:
            return False
        with torch.no_grad():
            t.copy_(v)
        return True
    return st is saved or st == saved


def _snapshot_training_state(params, trainer):
    """Copies of the weights, gradient buffers and optimizer state (the
    eager per-parameter ``_opt_state``, the Trainer's fused states, its
    update counts) before warmup steps run."""
    weights, grads, opt = [], [], []
    for p in params:
        hs = p.list_data() if p._data is not None else []
        weights.append([h.data.detach().clone() for h in hs])
        grads.append([h.grad.data.detach().clone() for h in hs
                      if h.grad is not None])
        had = "_opt_state" in p.__dict__
        opt.append((had, _copy_opt_state(p.__dict__.get("_opt_state"))))
    saved = {"w": weights, "g": grads, "opt": opt}
    if trainer is not None:
        saved["fused"] = {name: _copy_opt_state(st)
                          for name, st in trainer._fused_states.items()}
        saved["counts"] = dict(trainer._optimizer._index_update_count)
        saved["num_update"] = trainer._optimizer.num_update
    return saved


def _restore_training_state(params, trainer, saved):
    """Put back what :func:`_snapshot_training_state` copied, into the
    same tensors: every handle keeps its tensor and gradient buffer, and
    an optimizer state that existed keeps its tensors, so neither a
    captured graph nor the Trainer's plan sees a new tensor. A state
    created during warmup is dropped; the Trainer's plan is rebuilt over
    the states kept at its next step."""
    with torch.no_grad():
        for p, ws, gs, (had, st) in zip(params, saved["w"], saved["g"],
                                        saved["opt"]):
            if p._data is None:
                continue
            hs = p.list_data()
            for h, w in zip(hs, ws):
                h.data.copy_(w)
            for h, g in zip([h for h in hs if h.grad is not None], gs):
                h.grad.data.copy_(g)
            cur = p.__dict__.get("_opt_state")
            if had and not ("_opt_state" in p.__dict__
                            and _put_back_opt_state(cur, st)):
                p._opt_state = st
            elif not had and "_opt_state" in p.__dict__:
                del p._opt_state
    if trainer is not None:
        fused = saved["fused"]
        for name in list(trainer._fused_states):
            st = trainer._fused_states[name]
            if name not in fused or not _put_back_opt_state(st, fused[name]):
                del trainer._fused_states[name]
        for name, st in fused.items():
            trainer._fused_states.setdefault(name, st)
        trainer._optimizer._index_update_count = dict(saved["counts"])
        trainer._optimizer.num_update = saved["num_update"]
        trainer._invalidate_fused()


class _Halves:
    """One call's forward and backward over fixed tensors: ``inputs`` and
    the parameters' own, each differentiable one through a leaf that
    aliases its storage (so a captured graph reads the parameter where the
    optimizer writes it).

    ``forward()`` runs the block's eager forward and returns its output
    tensors; ``backward(outs, gouts)`` returns the gradients of the
    differentiable parameters, then of the floating inputs when
    ``tracked``. The shared-residual form (the default) records the
    forward and differentiates that graph, keeping it for a second
    backward. The legacy form (``legacy``: ``MXTPU_FUSED_STEP=0``, the
    JAX package's remat path) runs the forward unrecorded and has the
    backward run it again, recorded, over the auxiliary state as the
    forward found it (the forward copies it into ``scratch``, where the
    recompute also writes, so the state moves once per call) and, with
    ``keep_rng``, from the random state the forward started from."""

    def __init__(self, block, args, inputs, handles, diff_mask, training,
                 tracked, legacy, keep_rng):
        self.block, self.training = block, training
        self.legacy, self.keep_rng = legacy, keep_rng
        it = iter(inputs)
        self.args = [NDArray(next(it)) if isinstance(a, NDArray) else a
                     for a in args]
        self.diff = [h for h, d in zip(handles, diff_mask) if d]
        self.aux = [h for h, d in zip(handles, diff_mask) if not d]
        self.leaves = [h._t.detach().requires_grad_() for h in self.diff]
        self.wrt = self.leaves + [t for t in inputs if tracked
                                  and t.is_floating_point()]
        self.scratch = [torch.empty_like(h._t) for h in self.aux] \
            if legacy else []
        self.rng = None
        self.pack = None

    def run(self, recording, aux=()):
        """The eager forward over the bound tensors (``aux``, when given,
        in place of the auxiliary state); sets ``pack``, which wraps
        output tensors as the block returned its outputs."""
        with _bound(self.diff + (self.aux if aux else []),
                    self.leaves + list(aux)), \
                autograd._RecordingStateScope(recording, self.training):
            outs = self.block._eager_forward(*self.args)
        if isinstance(outs, NDArray):
            self.pack = lambda ts: NDArray(ts[0])
            return [outs._t]
        kind = type(outs)
        self.pack = lambda ts: kind(NDArray(t) for t in ts)
        return [o._t for o in outs]

    def forward(self):
        if not self.legacy:
            return self.run(True)
        with torch.no_grad():
            for s, h in zip(self.scratch, self.aux):
                s.copy_(h._t)
        if self.keep_rng:
            self.rng = _rng_state()
        return self.run(False)

    def backward(self, outs, gouts):
        if self.legacy:
            with contextlib.ExitStack() as stack:
                if self.rng is not None:
                    stack.enter_context(_rng_restored(self.rng))
                stack.enter_context(_hooks_muted())
                outs = self.run(True, self.scratch)
        pairs = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
        if not pairs or not self.wrt:
            return [None] * len(self.wrt)
        return list(torch.autograd.grad(
            [o for o, _ in pairs], self.wrt, [g for _, g in pairs],
            allow_unused=True, retain_graph=not self.legacy))


class _EagerCall:
    """A recorded call run uncaptured: its halves keep their own graph."""

    def __init__(self, halves):
        self.halves = halves
        self.outs = None

    @property
    def pack(self):
        return self.halves.pack

    def forward(self, inputs):
        del inputs  # the halves hold aliases of them
        self.outs = self.halves.forward()
        return [o.detach() for o in self.outs]

    def backward(self, gouts):
        return self.halves.backward(self.outs, gouts)


class _ReplayCall:
    """A recorded call that replays its entry's captured graphs."""

    def __init__(self, entry):
        self.entry = entry
        self.pack = entry.pack
        self.gen = None

    def forward(self, inputs):
        outs = self.entry.replay_forward(inputs)
        self.gen = self.entry.gen
        return outs

    def backward(self, gouts):
        return self.entry.replay_backward(self.gen, gouts)


class _CachedFunction(torch.autograd.Function):
    """One recorded call of a cached graph as one node of torch's autograd
    graph. Its tensor arguments are the differentiable parameters' own
    tensors (and the tracked inputs'), so ``autograd.backward`` routes the
    gradients to their buffers."""

    @staticmethod
    def forward(ctx, call, inputs, *tensors):
        ctx.call = call
        ctx.inputs, ctx.tensors = inputs, tensors
        outs = call.forward(inputs)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        if _obs.ENABLED:
            _obs.record_xla_dispatch("cachedop_bwd")
        if torch.is_grad_enabled():  # create_graph
            return (None, None) + tuple(_regrad(
                ctx.call.entry_args, ctx.inputs, ctx.tensors, gouts))
        return (None, None) + tuple(ctx.call.backward(gouts))


def _draws_random(block):
    """Does ``block`` (or a child) hold a Dropout with a nonzero rate?"""
    from .nn.basic_layers import Dropout

    if isinstance(block, Dropout) and block._rate > 0:
        return True
    return any(_draws_random(c) for c in block._children.values())


def _regrad(entry_args, inputs, tensors, gouts):
    """A recorded call's backward under ``create_graph``: the block's eager
    forward runs again over the very tensors the call was given, so its
    graph reaches the parameters and the inputs, and is differentiated
    with ``create_graph`` (a captured backward cannot be differentiated
    again; the JAX package replays its CachedOp the same way). The
    auxiliary state is put back after it. A block that draws random
    numbers in training would draw other ones, so it raises."""
    block, args, handles, diff_mask, training = entry_args
    if training and _draws_random(block):
        raise MXNetError(
            f"create_graph through hybridized {_block_name(block)}: its "
            "forward draws random numbers (Dropout), which a recompute "
            "would draw anew")
    diff = [h for h, d in zip(handles, diff_mask) if d]
    aux = [h for h, d in zip(handles, diff_mask) if not d]
    saved = [h._t.detach().clone() for h in aux]
    it = iter(inputs)
    nds = [NDArray(next(it)) if isinstance(a, NDArray) else a for a in args]
    with torch.enable_grad(), _bound(diff, tensors[:len(diff)]), \
            autograd._RecordingStateScope(True, training), _hooks_muted():
        outs = block._eager_forward(*nds)
    with torch.no_grad():
        for h, t in zip(aux, saved):
            h._t.copy_(t)
    outs = [outs] if isinstance(outs, NDArray) else list(outs)
    return autograd.recompute_grads(
        lambda *ts: [o._t for o in outs], tensors, gouts)


class _Entry:
    """One input signature of a cached graph.

    On a CUDA card the entry warms up once (one uncaptured forward, and
    backward when it records, on a side stream; the auxiliary state is
    put back after it), then captures the forward, and the backward when
    it records, into CUDA graphs sharing one memory pool; every call
    copies its inputs into the entry's static buffers, replays, and
    returns fresh copies of the outputs, so an output never changes under
    its holder. A parameter is read where it lies: BatchNorm's running
    statistics are written by ``copy_`` inside the graph, and the
    optimizer writes the weights in place. The gradients a replay returns
    are the backward graph's own buffers, rewritten by its next replay;
    ``autograd.backward`` copies them into the gradient buffers at once.
    ``holds`` tells whether every parameter handle still holds the tensor
    captured. On the CPU each call runs the same halves eagerly.

    Non-NDArray arguments (None, Python scalars) are baked in at the
    entry's first call and are not part of its key, as in the JAX
    package: a later call that passes another value gets the first."""

    def __init__(self, block, args, arrays, handles, diff_mask, training,
                 recording, tracked):
        self.block, self.args, self.diff_mask = block, args, diff_mask
        self.training, self.recording, self.tracked = \
            training, recording, tracked
        self.legacy = recording and not _fusedstep.ENABLED
        self.graphed = arrays[0]._t.is_cuda
        self.name = _block_name(block)
        self.gen = 0  # forward replays so far
        self.calls = 0
        self._awaiting = None  # the replayed call whose backward is due
        self.pack = None
        if self.graphed:
            with torch.cuda.device(arrays[0]._t.device):
                self._capture(arrays, handles)
        self.tensors = [h._t for h in handles]

    def holds(self, handles):
        return len(handles) == len(self.tensors) and all(
            h._t is t for h, t in zip(handles, self.tensors))

    def _halves(self, inputs, handles, keep_rng):
        return _Halves(self.block, self.args, inputs, handles,
                       self.diff_mask, self.training, self.tracked,
                       self.legacy, keep_rng)

    def _leaves(self, arrays, clone):
        return [(a._t.detach().clone() if clone else a._t.detach())
                .requires_grad_(self.tracked and a._t.is_floating_point())
                for a in arrays]

    def _capture(self, arrays, handles):
        static = self._leaves(arrays, clone=True)
        halves = self._halves(static, handles, keep_rng=False)
        aux = [h._t for h in halves.aux]
        saved = [t.clone() for t in aux]
        rng = torch.cuda.get_rng_state()

        def forward():
            return halves.forward() if self.recording \
                else halves.run(False)

        def once():
            outs = forward()
            if self.recording:
                halves.backward(outs, [torch.ones_like(o) for o in outs])

        _capture.warm_up(once)
        with torch.no_grad():
            for t, s in zip(aux, saved):
                t.copy_(s)
        if self.legacy and not torch.equal(rng, torch.cuda.get_rng_state()):
            _fusedstep.log_fallback(
                "cachedop", f"{self.name} draws random numbers, which a "
                "captured recompute would draw anew; its backward keeps "
                "the forward's residuals instead")
            self.legacy = halves.legacy = False
        pool = torch.cuda.graph_pool_handle()
        self._fwd = _capture.Graph(pool, f"the forward of {self.name}")
        with _hooks_muted():  # the warm-up ran them
            outs = self._fwd.capture(forward)
            if self.recording:
                self._gouts = [torch.zeros_like(o) for o in outs]
                self._bwd = _capture.Graph(pool,
                                           f"the backward of {self.name}")
                self._grads = self._bwd.capture(
                    lambda: halves.backward(outs, self._gouts))
        self._static = static
        self._outs = [o.detach() for o in outs]
        self.pack = halves.pack

    def replay_forward(self, inputs):
        with torch.no_grad():
            for s, t in zip(self._static, inputs):
                s.copy_(t)
        self._fwd.replay()
        self.gen += 1
        return [o.clone() for o in self._outs]

    def replay_backward(self, gen, gouts):
        if gen != self.gen:
            raise MXNetError(
                f"a backward of hybridized {self.name} ran after a later "
                "recorded call had overwritten the residuals it reads; "
                "run each backward before the next recorded call")
        with torch.no_grad():
            for s, g in zip(self._gouts, gouts):
                if g is not None and s.is_floating_point():
                    s.copy_(g)
        self._bwd.replay()
        self._awaiting = None
        return list(self._grads)

    def __call__(self, arrays, handles):
        # the children's hooks run while the entry is built (its first
        # eager run or its warm-up), never again, as at trace time in the
        # JAX package
        with _hooks_muted(self.graphed or self.calls > 0):
            self.calls += 1
            if _obs.ENABLED:
                # a replay of the captured forward, or one eager run
                _obs.record_xla_dispatch("cachedop_fwd")
            return self._call(arrays, handles)

    def _call(self, arrays, handles):
        if not self.recording:
            if self.graphed:
                return self.pack(self.replay_forward(
                    [a._t for a in arrays]))
            halves = self._halves([a._t for a in arrays], handles, False)
            outs = halves.run(False)
            return halves.pack(outs)
        pending = self._awaiting is not None and self._awaiting() is not None
        if self.graphed and not pending:
            call = _ReplayCall(self)
            self._awaiting = weakref.ref(call)
        else:
            if pending:
                _fusedstep.log_fallback(
                    "cachedop", f"{self.name} was called again under "
                    "record() before the backward of its last call; such "
                    "a call runs uncaptured")
            call = _EagerCall(self._halves(self._leaves(arrays, False),
                                           handles, True))
        call.entry_args = (self.block, self.args, handles, self.diff_mask,
                           self.training)
        tensors = [h._t for h, d in zip(handles, self.diff_mask) if d]
        if self.tracked:
            tensors += [a._t for a in arrays if a._t.is_floating_point()]
        outs = _CachedFunction.apply(call, [a._t for a in arrays], *tensors)
        return call.pack(list(outs))


class _CachedGraph:
    """The CachedOp of a hybridized block: one :class:`_Entry` per input
    signature (reference: ``src/imperative/cached_op.cc``).

    The key: each NDArray input's (shape, dtype), ``training``,
    ``recording``, ``inputs_tracked`` (an input requires grad) and
    ``recording and fusedstep.ENABLED`` and the AMP policy,
    ``(target_dtype, cast_ops)`` while it is on (None otherwise), so
    toggling ``amp.init`` or extending its fp32 list captures again, cause
    ``amp``. An entry whose parameter handles no longer hold the tensors it
    captured (``Parameter.cast``, a re-initialisation) is captured again,
    cause ``params``. The eager path runs only where the JAX package's does: arguments that are not flat
    (lists, tuples, keyword arguments) and the first call, which resolves
    deferred shapes. ``retrace_causes`` lists, in order, why each entry
    after the first was captured."""

    def __init__(self, block):
        self.block = block
        self._cache = {}
        self._last_key = None
        self._wobble_logged = False
        self.retrace_causes = []

    def _param_handles(self, ctx):
        handles, diff_mask = [], []
        for _, p in sorted(self.block.collect_params().items()):
            handles.append(p.data(ctx))
            diff_mask.append(p.grad_req != "null")
        return handles, diff_mask

    def __call__(self, args):
        arrays = [a for a in args if isinstance(a, NDArray)]
        if not arrays or any(isinstance(a, (list, tuple)) for a in args):
            return self.block._eager_forward(*args)
        try:
            handles, diff_mask = self._param_handles(arrays[0].context)
        except DeferredInitializationError:
            return self.block._eager_forward(*args)
        recording = autograd.is_recording()
        training = autograd.is_training()
        tracked = recording and any(a._t.requires_grad for a in arrays)
        amp = _amp_policy._STATE
        key = (tuple((a.shape, str(a.dtype)) for a in arrays), training,
               recording, tracked, recording and _fusedstep.ENABLED,
               None if amp["target_dtype"] is None
               else (amp["target_dtype"], amp["cast_ops"]))
        entry = self._cache.get(key)
        if entry is not None and entry.holds(handles):
            if _obs.ENABLED:
                _obs.CACHEDOP_CACHE_HITS.inc(1, block=entry.name)
            self._last_key = key
            return entry(arrays, handles)
        cause = "params" if entry is not None else self._retrace_cause(key)
        t0 = time.perf_counter()
        entry = _Entry(self.block, args, arrays, handles, diff_mask,
                       training, recording, tracked)
        out = entry(arrays, handles)  # an entry that fails is not kept
        self._cache[key] = entry
        self._last_key = key
        if cause is not None:
            self.retrace_causes.append(cause)
            _logger.info("hybridized %s captured again (%s)", entry.name,
                         cause)
        self._check_retrace_budget()
        if _obs.ENABLED:
            _obs.record_compile(entry.name, time.perf_counter() - t0, cause)
        return out

    def _check_retrace_budget(self):
        """Shape-wobble guard (``MXTPU_RETRACE_BUDGET``): a block that
        captured more distinct input-shape signatures than the budget is
        almost always fed an unstabilised input pipeline (partial last
        batches, unbucketed lengths). Warn once per block."""
        budget = _fusedstep.retrace_budget()
        if budget <= 0:
            return
        n_shapes = len({k[0] for k in self._cache})
        if n_shapes <= budget:
            return
        name = _block_name(self.block)
        if _obs.ENABLED:
            _obs.SHAPE_WOBBLE_TOTAL.inc(1, block=name)
        if not self._wobble_logged:
            self._wobble_logged = True
            _logger.warning(
                "shape_wobble: block %r has captured %d distinct input-"
                "shape signatures (budget %d, MXTPU_RETRACE_BUDGET). Pad "
                "partial batches and bucket variable-length inputs.",
                name, n_shapes, budget)

    def _retrace_cause(self, new_key):
        """Why a new entry was needed: the new key against the previous
        call's (None for the first entry)."""
        if self._last_key is None:
            return None
        o_sig, o_train, o_rec, o_tracked, o_fused, o_amp = self._last_key
        n_sig, n_train, n_rec, n_tracked, n_fused, n_amp = new_key
        causes = signature_causes(o_sig, n_sig)
        if o_train != n_train:
            causes.append("training")
        if o_rec != n_rec:
            causes.append("recording")
        if o_tracked != n_tracked:
            causes.append("inputs_tracked")
        if o_fused != n_fused:
            causes.append("fused_step")
        if o_amp != n_amp:
            causes.append("amp")
        return "+".join(causes) or "unknown"
