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
    def ndim(self) -> int:
        return len(self.shape)

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

    def _set_data(self, value):
        """Overwrite the contents in place (never recorded): how an
        operator writes back auxiliary state such as BatchNorm's running
        statistics."""
        with torch.no_grad():
            self._t.copy_(_unwrap(value).detach())

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

    def __abs__(self):
        return apply(torch.abs, self)

    # comparisons return the input's floating type (1.0 / 0.0), as MXNet's
    # broadcast_equal family does (float32 for integer inputs)
    def _compare(self, fn, other):
        def op(a, b):
            r = fn(a, b)
            dt = a.dtype if a.is_floating_point() else torch.float32
            return r.to(dt)

        return self._binop(op, other)

    def __eq__(self, o):
        return self._compare(torch.eq, o)

    def __ne__(self, o):
        return self._compare(torch.ne, o)

    def __lt__(self, o):
        return self._compare(torch.lt, o)

    def __le__(self, o):
        return self._compare(torch.le, o)

    def __gt__(self, o):
        return self._compare(torch.gt, o)

    def __ge__(self, o):
        return self._compare(torch.ge, o)

    def __hash__(self):
        return id(self)


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


def full(shape, val, ctx=None, dtype="float32") -> NDArray:
    return _filled(val, shape, ctx, dtype)


def waitall():
    """Wait for all queued device work (a CUDA sync, where deferred
    device errors surface); nothing to wait for on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# save / load: the NDARRAY_V2 container shared with the JAX package
# ---------------------------------------------------------------------------


def save(fname, data):
    """Save NDArrays (one, a list, or a ``{name: NDArray}`` dict) in the
    reference binary format (``NDArray::Save``, magic ``NDARRAY_V2``
    inside the 0x112 list container), written from the host. The file
    loads in the JAX package's ``mx.nd.load`` and in reference MXNet. A
    dtype the container has no flag for (bool) makes the whole file an
    ``.npz``, as in the JAX package; ``load`` reads both (bfloat16 is
    written as float32 there)."""
    from . import serialization

    if isinstance(data, NDArray):
        arrays, names = [data], []
    elif isinstance(data, (list, tuple)):
        arrays, names = list(data), []
    elif isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        raise TypeError(f"cannot save type {type(data)}")
    if not all(isinstance(a, NDArray) for a in arrays):
        raise TypeError("nd.save takes NDArrays")
    tensors = [a._t for a in arrays]
    try:
        for t in tensors:
            serialization.flag_of(t.dtype)
    except MXNetError:
        payload = ({f"__mxtpu_list_{i}": a.asnumpy()
                    for i, a in enumerate(arrays)} if not names else
                   {k: a.asnumpy() for k, a in zip(names, arrays)})
        with open(fname, "wb") as f:  # exact fname (savez appends .npz)
            _np.savez(f, **payload)
        return
    serialization.save_params(fname, tensors, names)


def _load_host(fname):
    """What ``fname`` holds, as CPU tensors: a list, or a dict when the
    file names its arrays."""
    from . import serialization

    fmt = serialization.sniff_format(fname)
    if fmt == "ndarray_v2":
        tensors, names = serialization.load_params(fname)
        return dict(zip(names, tensors)) if names else tensors
    if fmt != "npz":
        raise MXNetError(f"{fname} is neither an MXNet .params file nor "
                         "an .npz")
    with _np.load(fname, allow_pickle=False) as z:
        keys = list(z.keys())
        if keys and all(k.startswith("__mxtpu_list_") for k in keys):
            keys.sort(key=lambda k: int(k.rsplit("_", 1)[1]))
            return [torch.from_numpy(_np.array(z[k])) for k in keys]
        return {k: torch.from_numpy(_np.array(z[k])) for k in keys}


def load(fname):
    """Load what :func:`save` (or the JAX package, or reference MXNet)
    wrote: a list of NDArrays, or a dict when the file names them. The
    arrays keep the file's dtypes and are placed on the current context
    (the first CUDA card unless a ``with mx.cpu():`` block says
    otherwise)."""
    dev = _device(None)
    res = _load_host(fname)
    if isinstance(res, dict):
        return {k: NDArray(t.to(dev)) for k, t in res.items()}
    return [NDArray(t.to(dev)) for t in res]
