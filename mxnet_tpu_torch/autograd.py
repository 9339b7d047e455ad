"""MXNet's autograd surface over ``torch.autograd``.

PyTorch counterpart of ``mxnet_tpu/autograd.py``. ``record()`` turns
recording on for the thread: operators of the ``nd`` namespace then build
a ``torch.autograd`` graph (outside it they run under ``torch.no_grad()``).
``train_mode``/``predict_mode`` only set the flag that layers such as
``Dropout`` read.

:func:`backward` keeps MXNet's gradient semantics, which differ from
torch's ``.grad``: each array that called ``attach_grad`` owns a gradient
buffer, ``grad_req="write"`` OVERWRITES it on every backward and only
``"add"`` accumulates; a buffer that receives no gradient is left as it
was; a head that is not a scalar is seeded with ones. An attached array
written after it was recorded keeps its earlier leaf tensors as gradient
targets (``ndarray.py``: writes and the tape), and their gradients are
summed into its one buffer, so a mutated leaf neither loses nor
double-counts a contribution.

:func:`grad` returns gradients without touching the buffers;
``create_graph=True`` records the gradient computation, so it can be
differentiated again. It refuses, with :class:`MXNetError`, where the JAX
package refuses: outside ``record()``, for a variable that is not on the
tape, after a variable was written in place on the tape, and through a
custom :class:`Function` (its backward is opaque). ``get_symbol`` needs
the symbol layer (ROADMAP A13).
"""

from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()

# every live NDArray with an attached gradient buffer, by id (an NDArray's
# == is element-wise, so it cannot sit in a WeakSet)
_LEAVES: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _register_leaf(arr):
    _LEAVES[id(arr)] = arr


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(is_record: bool) -> bool:
    """Turn recording on or off for the thread; returns the previous
    state."""
    prev, _STATE.recording = _STATE.recording, bool(is_record)
    return prev


def set_training(train_mode: bool) -> bool:
    """Turn training mode on or off for the thread; returns the previous
    state."""
    prev, _STATE.training = _STATE.training, bool(train_mode)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter = (is_record, train_mode)
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training)
        is_record, train = self._enter
        if is_record is not None:
            _STATE.recording = is_record
        if train is not None:
            _STATE.training = train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training = self._prev
        return False


def record(train_mode: bool = True):
    """Scope in which operators are recorded for :func:`backward`."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope in which nothing is recorded (inside ``record()``)."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def is_tracked(arr) -> bool:
    """Does gradient flow through this array (on the tape, or attached)?"""
    return arr._t.requires_grad or arr._grad is not None


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach ``gradients`` (NDArrays) as the gradient buffers of
    ``variables`` (reference: ``autograd.py:mark_variables``)."""
    from .ndarray.ndarray import NDArray

    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var.attach_grad(req)
        if req != "null":
            var._grad = g


def _heads_and_seeds(heads, head_grads):
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        if not h._t.requires_grad:
            raise MXNetError(
                "cannot differentiate a head that is not on the tape; run "
                "inside autograd.record() and/or attach_grad()")
        outs.append(h._t)
        seeds.append(torch.ones_like(h._t) if hg is None
                     else hg._t.to(h._t.dtype))
    return outs, seeds


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True):
    """Gradients of ``heads`` (NDArrays) into the buffers of every array
    that called ``attach_grad`` and lies on their graph.

    ``head_grads`` default to ones of each head's shape (MXNet seeds a
    non-scalar head that way). Reference: ``Imperative::Backward``."""
    del train_mode  # the forward already ran in its mode
    outs, seeds = _heads_and_seeds(heads, head_grads)
    owners, targets = [], []
    for a in list(_LEAVES.values()):
        if a._grad is None:
            continue
        for t in a._leaf_tensors():
            owners.append(a)
            targets.append(t)
    if not targets:
        return
    grads = torch.autograd.grad(outs, targets, seeds,
                                retain_graph=retain_graph, allow_unused=True)
    total = {}
    for arr, g in zip(owners, grads):
        if g is not None:
            prev = total.get(id(arr))
            total[id(arr)] = (arr, g if prev is None else prev[1] + g)
    with torch.no_grad():
        for arr, g in total.values():
            if arr._grad_req == "add":
                arr._grad._t.add_(g)
            else:
                arr._grad._t.copy_(g)
            if not retain_graph:
                arr._settle()


def _opaque_nodes(outs):
    """Names of the custom-Function backward nodes on the graph of
    ``outs`` (their backward cannot be differentiated again)."""
    found, seen = [], set()
    stack = [t.grad_fn for t in outs if t.grad_fn is not None]
    while stack:
        node = stack.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        if type(node).__name__ == "_CustomFunctionBackward":
            found.append(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return found


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` (reference:
    ``autograd.py:grad``), returned as new arrays; the gradient buffers
    are not touched. With ``create_graph`` the gradients are recorded, so
    they can be differentiated again."""
    from .ndarray.ndarray import NDArray

    del train_mode
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if create_graph:
        if not is_recording():
            raise MXNetError(
                "create_graph=True must be called inside autograd.record(): "
                "the returned gradients are recorded on the tape")
        for v in variables:
            if not is_tracked(v):
                raise MXNetError(
                    "create_graph=True requires every variable to be tracked "
                    "(attach_grad() before recording, or be on the tape)")
            if any(r() is not None for r in (v._vers or ())):
                raise MXNetError(
                    "create_graph=True on a tape where a variable was "
                    "mutated in place after it was recorded is not "
                    "supported")
    outs, seeds = _heads_and_seeds(heads, head_grads)
    if create_graph and _opaque_nodes(outs):
        raise MXNetError(
            "create_graph=True cannot differentiate through a custom "
            "autograd.Function: its backward is opaque to higher-order "
            "grad")
    owners, targets = [], []
    for i, v in enumerate(variables):
        ts = v._leaf_tensors() if v._grad is not None else \
            ([v._t] if v._t.requires_grad else [])
        if not ts:
            raise MXNetError("a variable of grad() is not on the tape; "
                             "attach_grad() it before recording")
        owners += [i] * len(ts)
        targets += ts
    keep = bool(retain_graph) if retain_graph is not None else create_graph
    with torch.set_grad_enabled(create_graph):
        gs = torch.autograd.grad(outs, targets, seeds, retain_graph=keep,
                                 create_graph=create_graph,
                                 allow_unused=True)
    res = [None] * len(variables)
    for i, g in zip(owners, gs):
        if g is not None:
            res[i] = g if res[i] is None else res[i] + g
    out = []
    for g, v, t in zip(res, variables, (v._t for v in variables)):
        if g is None:
            g = torch.zeros_like(t, requires_grad=False)
        if create_graph and not g.requires_grad:
            # a gradient constant in the variables (relu's): still on the
            # tape, with a zero derivative, as the JAX package records it
            with torch.enable_grad():
                g = g + 0.0 * t
        out.append(NDArray(g))
    return out[0] if single else out


def recompute_grads(fn, inputs, gouts):
    """The backward of a hand-written ``torch.autograd.Function`` under
    ``create_graph``: ``fn(*inputs)`` (a differentiable recompute of its
    forward, in plain torch ops) differentiated with ``create_graph``, so
    the gradient is itself on the graph, as the JAX package
    differentiates its ``custom_vjp`` rules. One gradient per input (None
    where an input needs none)."""
    with torch.enable_grad():
        outs = fn(*inputs)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        need = [i for i in inputs
                if isinstance(i, torch.Tensor) and i.requires_grad]
        pairs = [(o, g) for o, g in zip(outs, gouts)
                 if g is not None and o.requires_grad]
        if not need or not pairs:
            return [None] * len(inputs)
        gs = iter(torch.autograd.grad(
            [o for o, _ in pairs], need, [g for _, g in pairs],
            create_graph=True, allow_unused=True))
    return [next(gs) if isinstance(i, torch.Tensor) and i.requires_grad
            else None for i in inputs]


def get_symbol(x):
    """Export the recorded computation as a Symbol: needs the symbol layer
    (ROADMAP A13)."""
    raise MXNetError("autograd.get_symbol needs the symbol/ layer, which "
                     "the port does not have yet (ROADMAP A13)")


class _CustomFunction(torch.autograd.Function):
    """A :class:`Function` as one node of torch's graph: the forward's
    outputs are computed already; the backward calls the user's."""

    @staticmethod
    def forward(ctx, func, n_in, *tensors):
        ctx.func = func
        ctx.n_in = n_in
        outs = tensors[n_in:]
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *gouts):
        from .ndarray.ndarray import NDArray

        func = ctx.func
        with pause():
            gs = func.backward(*[NDArray(g.detach()) for g in gouts])
        if isinstance(gs, NDArray):
            gs = [gs]
        grads = [g._t if isinstance(g, NDArray) else g for g in gs]
        grads += [None] * (ctx.n_in - len(grads))
        return (None, None, *grads[:ctx.n_in],
                *([None] * (len(gouts))))


class Function:
    """A differentiable function with a hand-written backward (reference:
    ``autograd.Function``). Subclass it with ``forward`` and ``backward``
    over NDArrays. The forward runs with recording paused; under
    ``record()`` the call becomes one node of the graph whose backward is
    this ``backward`` (one gradient per NDArray input)."""

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return getattr(self, "_saved", ())

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        with pause():
            outputs = self.forward(*inputs)
        single = isinstance(outputs, NDArray)
        outs = [outputs] if single else list(outputs)
        arrays = [i for i in inputs if isinstance(i, NDArray)]
        if not (is_recording() and any(is_tracked(a) for a in arrays)):
            return outputs
        with torch.enable_grad():
            res = _CustomFunction.apply(self, len(arrays),
                                        *[a._t for a in arrays],
                                        *[o._t for o in outs])
        wrapped = [NDArray(t) for t in res]
        return wrapped[0] if single else wrapped
