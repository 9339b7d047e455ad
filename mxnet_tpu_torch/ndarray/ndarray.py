"""NDArray: MXNet's imperative tensor handle over a ``torch.Tensor``.

PyTorch counterpart of ``mxnet_tpu/ndarray/ndarray.py``. An NDArray owns
one tensor on one device. Basic slicing returns a view that aliases its
base (torch views share storage), so ``b = a[1:3]; b[:] = 0`` writes into
``a`` as in MXNet. Every operator runs through :func:`apply`, which
records a ``torch.autograd`` graph only inside ``autograd.record()``; an
operator outside it runs under ``torch.no_grad()``, so nothing is kept
for a backward that will not come.

Constructors place on :func:`~mxnet_tpu_torch.context.current_context`
when no ``ctx`` is given: the first CUDA card unless a ``with ctx:``
block says otherwise. Without a card they raise unless ``ctx=mx.cpu()``.
"""

from __future__ import annotations

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError
from ..context import Context, current_context, resolve_device

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """``"float32"`` / ``np.float32`` / ``torch.float32`` -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return _TORCH_DTYPES[name]


def _device(ctx) -> torch.device:
    return resolve_device(Context(ctx) if ctx is not None
                          else current_context())


def _unwrap(x):
    return x._t if isinstance(x, NDArray) else x


def _wrap(res):
    if isinstance(res, torch.Tensor):
        return NDArray(res)
    if isinstance(res, (tuple, list)):
        return type(res)(_wrap(r) for r in res)
    return res


def apply(fn, *args, **kwargs):
    """Run ``fn`` on the tensors behind ``args``/``kwargs`` and wrap the
    result(s); the graph is recorded only while ``autograd.record()`` is
    on."""
    with torch.set_grad_enabled(autograd.is_recording()):
        res = fn(*[_unwrap(a) for a in args],
                 **{k: _unwrap(v) for k, v in kwargs.items()})
    return _wrap(res)


class NDArray:
    """An n-dimensional array on one device (reference: ``NDArray``)."""

    __slots__ = ("_t", "_grad", "_grad_req", "__weakref__")

    # numpy's binary operators defer to ours
    __array_priority__ = 1000.0

    def __init__(self, tensor: torch.Tensor):
        self._t = tensor
        self._grad = None
        self._grad_req = "null"

    # -- metadata ------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        """The tensor behind this handle."""
        return self._t

    @property
    def shape(self) -> tuple:
        return tuple(self._t.shape)

    @property
    def dtype(self):
        """A numpy dtype (``torch.bfloat16`` itself for bfloat16)."""
        if self._t.dtype == torch.bfloat16:
            return torch.bfloat16
        return _np.dtype(str(self._t.dtype).split(".")[1])

    @property
    def size(self) -> int:
        return self._t.numel()

    @property
    def context(self) -> Context:
        return Context(self._t.device)

    ctx = context

    def __repr__(self):
        return f"\n{self.asnumpy()!r}\n<NDArray {self.shape} @{self.context}>"

    # -- host transfer and synchronisation -----------------------------
    def asnumpy(self) -> _np.ndarray:
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def wait_to_read(self):
        """Wait for the work that produces this array (a CUDA sync on its
        device, where device errors surface)."""
        if self._t.is_cuda:
            torch.cuda.synchronize(self._t.device)

    # -- conversion and shape -----------------------------------------
    def astype(self, dtype, copy=True) -> "NDArray":
        dt = torch_dtype(dtype)
        if not copy and dt == self._t.dtype:
            return self
        return apply(lambda t: t.to(dt), self)

    def reshape(self, *shape, **kwargs):
        from ..ops.shape_ops import reshape

        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return apply(reshape, self, shape=kwargs.get("shape", shape))

    def sum(self, axis=None, keepdims=False, exclude=False):
        from ..ops.math import sum as _sum

        return apply(_sum, self, axis=axis, keepdims=keepdims,
                     exclude=exclude)

    # -- autograd -----------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a leaf that receives gradients in ``grad``:
        ``"write"`` overwrites it on every backward, ``"add"``
        accumulates, ``"null"`` detaches it."""
        del stype
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null; got "
                             f"{grad_req!r}")
        self._t = self._t.detach()
        self._grad_req = grad_req
        if grad_req == "null":
            self._grad = None
            return
        self._t.requires_grad_(True)
        self._grad = NDArray(torch.zeros_like(self._t))
        autograd._register_leaf(self)

    @property
    def grad(self):
        return self._grad

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- indexing -----------------------------------------------------
    def __getitem__(self, idx):
        idx = _unwrap(idx)
        if isinstance(idx, torch.Tensor) and idx.dtype != torch.bool:
            idx = idx.long()
        return apply(lambda t: t[idx], self)

    def __setitem__(self, idx, value):
        """Writes in place (through views into their base); never
        recorded."""
        idx = _unwrap(idx)
        with torch.no_grad():
            v = _unwrap(value)
            if isinstance(v, _np.ndarray):
                v = torch.from_numpy(v)
            if isinstance(v, torch.Tensor):
                v = v.to(device=self._t.device, dtype=self._t.dtype)
            self._t[idx] = v

    # -- arithmetic ---------------------------------------------------
    def _binop(self, fn, other, reverse=False):
        if isinstance(other, _np.ndarray):
            other = torch.from_numpy(other).to(self._t.device)
        a, b = (other, self) if reverse else (self, other)
        return apply(fn, a, b)

    def __add__(self, o):
        return self._binop(torch.add, o)

    def __radd__(self, o):
        return self._binop(torch.add, o, True)

    def __sub__(self, o):
        return self._binop(torch.sub, o)

    def __rsub__(self, o):
        return self._binop(torch.sub, o, True)

    def __mul__(self, o):
        return self._binop(torch.mul, o)

    def __rmul__(self, o):
        return self._binop(torch.mul, o, True)

    def __truediv__(self, o):
        return self._binop(torch.true_divide, o)

    def __rtruediv__(self, o):
        return self._binop(torch.true_divide, o, True)

    def __pow__(self, o):
        return self._binop(torch.pow, o)

    def __neg__(self):
        return apply(torch.neg, self)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An NDArray from an NDArray, numpy array or nested list. float64
    becomes float32 unless ``dtype`` says otherwise; ``ctx`` defaults to
    the current context (the first CUDA card)."""
    if isinstance(source_array, NDArray):
        t = source_array._t.detach()
    else:
        a = _np.asarray(source_array)
        if dtype is None and a.dtype == _np.float64:
            a = a.astype(_np.float32)
        t = torch.from_numpy(_np.ascontiguousarray(a))
    dev = _device(ctx)
    t = t.to(device=dev, dtype=torch_dtype(dtype) if dtype else None,
             copy=True)
    return NDArray(t)


def _filled(fill, shape, ctx, dtype):
    """``shape`` filled with ``fill`` on ``ctx`` (the current context by
    default)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.full(shape, fill, dtype=torch_dtype(dtype or
                                                              "float32"),
                              device=_device(ctx)))


def zeros(shape, ctx=None, dtype="float32") -> NDArray:
    return _filled(0, shape, ctx, dtype)


def ones(shape, ctx=None, dtype="float32") -> NDArray:
    return _filled(1, shape, ctx, dtype)


def waitall():
    """Wait for all queued device work (a CUDA sync, where deferred
    device errors surface); nothing to wait for on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
