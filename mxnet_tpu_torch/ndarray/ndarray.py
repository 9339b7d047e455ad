"""NDArray: MXNet's imperative tensor handle over a ``torch.Tensor``.

PyTorch counterpart of ``mxnet_tpu/ndarray/ndarray.py``. An NDArray owns
one tensor on one device. Every operator runs through :func:`apply`,
which records a ``torch.autograd`` graph only inside ``autograd.record()``;
an operator outside it runs under ``torch.no_grad()``, so nothing is kept
for a backward that will not come.

**Which arrays share a write.** A write through an NDArray (``a[i] = v``,
``a += b``, ``copyto``, ``out=``) is seen by exactly the arrays that see
it in the JAX package: the array itself, its basic-index views
(``a[1:3]``, ``a[0]``: a :class:`_View` names its base and index and
reads through it, so ``b = a[1:3]; b[:] = 0`` writes into ``a``), and
``astype(copy=False)`` of the same type (the same handle). Every other
result is a new array, even where torch returns a view of the input
(``reshape``, ``transpose``, ``expand_dims``, ``split``, ``detach`` ...):
such results share the input's storage until one of them is written
(copy on write). :func:`apply` records the sharing in an alias group, and
a write first gives the other members their own copy when the written
array is the group's origin, or gives the written array its own copy when
it is a derived member. So reads never copy, and the written array keeps
its storage: parameters, BatchNorm's running statistics, gradient buffers
and optimizer states are written where CUDA graphs and the Trainer's plan
hold them.

**Writes and the tape.** A write inside ``autograd.record()`` to an
array on the tape (or of a value on it) is recorded: the array's handle
takes a new tensor, a copy of the old one with the write applied,
through differentiable ops, so gradients are zeroed through the
overwritten positions and flow into the written value, while consumers
recorded before the write keep theirs. Outside ``record()`` a write to
an array the tape still holds (an attached array a live graph reads, or
any array with a graph behind it) also takes a new tensor, so a later
backward sees the values the tape recorded. An attached array keeps its
earlier leaf tensors (weakly, while a graph holds them) as gradient
targets, so their gradients land in the same ``grad``. Other writes are
in place.

Constructors place on :func:`~mxnet_tpu_torch.context.current_context`
when no ``ctx`` is given: the first CUDA card unless a ``with ctx:``
block says otherwise. Without a card they raise unless ``ctx=mx.cpu()``.
"""

from __future__ import annotations

import weakref

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError, is_int
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


def apply(fn, *args, **kwargs):
    """Run ``fn`` on the tensors behind ``args``/``kwargs`` and wrap the
    result(s); the graph is recorded only while ``autograd.record()`` is
    on. A result that shares storage with an input joins the input's
    alias group (module docstring)."""
    seen = []

    def un(x):
        if isinstance(x, NDArray):
            t = x._t
            seen.append((x, t))
            return t
        return x

    with torch.set_grad_enabled(autograd.is_recording()):
        res = fn(*[un(a) for a in args],
                 **{k: un(v) for k, v in kwargs.items()})
    return _wrap(res, seen)


def _wrap(res, seen=()):
    if isinstance(res, torch.Tensor):
        # a result takes the context of the op's first input, as in the
        # JAX package (``context`` checks it still fits the device)
        out = NDArray(res, seen[0][0]._ctx if seen else None)
        if seen and (res._base is not None
                     or any(res is t for _, t in seen)):
            _link(out, res, seen)
        return out
    if isinstance(res, (tuple, list)):
        return type(res)(_wrap(r, seen) for r in res)
    return res


def _link(out, res, seen):
    """Put ``out`` in the alias group of the input whose storage its
    tensor ``res`` shares (a torch view of it, or the same tensor; by the
    storage's address for a view of a detached tensor)."""
    base = res._base if res._base is not None else res
    for arr, t in seen:
        if t is res or (t._base if t._base is not None else t) is base:
            _join(arr._root(), out)
            return
    ptr = _storage(res)
    for arr, t in seen:
        if _storage(t) == ptr:
            _join(arr._root(), out)
            return


def _join(src, out):
    """An alias group is a list of weak references to root NDArrays that
    share one storage: the origin first, then the arrays derived from it
    by ops that returned views."""
    g = src._alias
    if g is None:
        g = src._alias = [weakref.ref(src)]
    elif len(g) > 64:
        g[1:] = [r for r in g[1:] if r() is not None and r()._alias is g]
    out._alias = g
    g.append(weakref.ref(out))


def _storage(t):
    # a sharded tensor (DTensor) has no storage of its own: its shard's
    local = getattr(t, "_local_tensor", None)
    return (local if local is not None else t).untyped_storage().data_ptr()


def _held(t) -> bool:
    """Does anything beyond its handle hold this leaf tensor (a recorded
    graph, a view)? Then an in-place write would change what the tape
    saw."""
    count = getattr(t, "_use_count", None)
    return count is None or count() > 1


def _reverses(idx) -> bool:
    """Is ``idx`` a basic index with a negative step somewhere?"""
    items = idx if isinstance(idx, tuple) else (idx,)
    return _is_basic_index(idx) and any(
        isinstance(i, slice) and i.step is not None and i.step < 0
        for i in items)


def _positive(t, idx):
    """A basic index with negative steps as torch takes it: the same
    elements through positive steps, and the result's dims to flip after
    (torch has no negative strides). ``t[pos].flip(dims)`` reads
    ``t[idx]``; ``t[pos]`` is the torch view a write goes through."""
    items = list(idx) if isinstance(idx, tuple) else [idx]
    if any(i is Ellipsis for i in items):
        at = items.index(Ellipsis)
        used = sum(1 for i in items if i is not None and i is not Ellipsis)
        items[at:at + 1] = [slice(None)] * (t.dim() - used)
    pos, flips, dim, out_dim = [], [], 0, 0
    for i in items:
        if i is None:
            pos.append(None)
            out_dim += 1
            continue
        if isinstance(i, slice):
            if i.step is not None and i.step < 0:
                picked = range(*i.indices(t.shape[dim]))
                if len(picked):
                    i = slice(picked[-1], picked[0] + 1, -i.step)
                    flips.append(out_dim)
                else:
                    i = slice(0, 0)
            out_dim += 1
        pos.append(i)
        dim += 1
    return tuple(pos), flips


def _read(t, idx):
    """``t[idx]`` for a basic index; a negative step reads through
    ``flip`` (a copy)."""
    if not _reverses(idx):
        return t[idx]
    pos, flips = _positive(t, idx)
    out = t[pos]
    return out.flip(flips) if flips else out


def _select(t, path):
    for ix in path:
        t = t[ix]
    return t


def _assign_path(t, path, idx, v):
    """Write ``v`` at ``idx`` of ``t[path[0]][path[1]]...``. A step of the
    chain with a negative step writes into a flipped copy of the positive
    view and copies it back, so the write lands in ``t``."""
    chain = list(path) + ([] if idx is None else [idx])
    at = next((k for k, ix in enumerate(chain) if _reverses(ix)), None)
    if at is None:
        _assign(_select(t, path), idx, v)
        return
    t = _select(t, chain[:at])
    pos, flips = _positive(t, chain[at])
    sub = t[pos]
    tmp = sub.flip(flips) if flips else sub.clone()
    rest = chain[at + 1:]
    if rest:
        _assign_path(tmp, rest[:-1], rest[-1], v)
    else:
        _assign(tmp, None, v)
    sub.copy_(tmp.flip(flips) if flips else tmp)


def _as_value(v, like):
    """A written value as ``like``'s device and type (scalars stay)."""
    v = _unwrap(v)
    if isinstance(v, (_np.ndarray, list, tuple)):
        v = torch.as_tensor(_np.asarray(v))
    if isinstance(v, torch.Tensor):
        v = v.to(device=like.device, dtype=like.dtype)
    return v


def _assign(t, idx, v):
    if idx is None:
        t.copy_(v) if isinstance(v, torch.Tensor) else t.fill_(v)
    else:
        t[idx] = v


_BASIC_TYPES = (int, slice, type(Ellipsis), type(None))


def _is_basic_index(idx) -> bool:
    if isinstance(idx, tuple):
        return all(isinstance(i, _BASIC_TYPES) or is_int(i) for i in idx)
    return isinstance(idx, _BASIC_TYPES) or is_int(idx)


def _index_tensor(idx, device):
    """An advanced index as torch takes it: integer arrays as int64 on
    ``device``, boolean masks as they are."""
    if isinstance(idx, NDArray):
        idx = idx._t
    elif isinstance(idx, (list, _np.ndarray)):
        idx = torch.as_tensor(_np.asarray(idx))
    if isinstance(idx, torch.Tensor):
        idx = idx.to(device)
        return idx if idx.dtype == torch.bool else idx.long()
    if isinstance(idx, tuple):
        return tuple(_index_tensor(i, device) if not (
            isinstance(i, _BASIC_TYPES) or is_int(i)) else i for i in idx)
    return idx


def _take_index(key, t):
    """An NDArray key reads as the JAX package's ``jnp.take`` along axis
    0: whatever its type (a bool key too), its values are row indices,
    negative ones counted from the end. A key outside ``[-n, n)`` raises
    (``jnp.take`` fills NaN there)."""
    idx = key._t.to(t.device).long()
    n = t.shape[0] if t.dim() else 0
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        return idx  # no host read inside a capture
    if idx.numel() and (bool((idx >= n).any()) or bool((idx < -n).any())):
        raise MXNetError(f"index {key._t.tolist()} out of range for axis 0 "
                         f"of size {n}")
    return idx


def _check_held(t):
    """A tensor that a tensor-parallel ``SPMDTrainStep`` released holds no
    values to read or write in place."""
    if t.is_meta:
        raise MXNetError(
            "this parameter's values are held by a tensor-parallel "
            "SPMDTrainStep as each rank's block; call the step's "
            "sync_to_block() first")


class NDArray:
    """An n-dimensional array on one device (reference: ``NDArray``)."""

    __slots__ = ("_t", "_ctx", "_grad", "_grad_req", "_alias", "_vers",
                 "__weakref__")

    # numpy's binary operators defer to ours
    __array_priority__ = 1000.0

    def __init__(self, tensor: torch.Tensor, ctx=None):
        self._t = tensor
        self._ctx = ctx  # the Context it was placed on (None: the device's)
        self._grad = None
        self._grad_req = "null"
        self._alias = None
        self._vers = None

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
        """The context the array was placed on (``cpu(1)`` stays
        ``cpu(1)``, though every host context is torch's one CPU), else
        the one its tensor's device names."""
        c = self._ctx
        if c is not None and c._places(self._t.device):
            return c
        return Context(self._t.device)

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return apply(_s.transpose, self)

    def tostype(self, stype):
        """Dense only: sparse storage types are ROADMAP A13's."""
        if stype == "default":
            return self
        raise MXNetError(f"tostype({stype!r}): sparse storage is not in "
                         "the port yet (ROADMAP A13)")

    def __repr__(self):
        return (f"\n{self.asnumpy()!r}\n<NDArray "
                f"{'x'.join(str(d) for d in self.shape)} @{self.context}>")

    __str__ = __repr__

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self.asnumpy().reshape(())[()])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- host transfer and synchronisation -----------------------------
    def asnumpy(self) -> _np.ndarray:
        _check_held(self._t)
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __index__(self):
        return int(self.asscalar())

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def wait_to_read(self):
        """Wait for the work that produces this array (a CUDA sync on its
        device, where device errors surface)."""
        from .. import engine

        engine.wait(self)

    def wait_to_write(self):
        self.wait_to_read()

    def __reduce__(self):
        ctx = self.context
        return (_rebuild, (self.asnumpy(), ctx.device_type, ctx.device_id))

    # -- the storage model (module docstring) ---------------------------
    def _root(self) -> "NDArray":
        return self

    def _root_path(self):
        return self, []

    def _cow(self):
        """Before an in-place write to this root: separate it from the
        other arrays that share its storage."""
        g = self._alias
        if g is None:
            return
        if g[0]() is not self:
            self._privatize()
            return
        ptr = _storage(self._t)
        for ref in g[1:]:
            m = ref()
            if m is not None and m._alias is g and _storage(m._t) == ptr:
                m._privatize()
        del g[1:]

    def _privatize(self):
        t = self._t
        with torch.set_grad_enabled(t.requires_grad and not t.is_leaf):
            new = t.clone()
        if t.is_leaf and t.requires_grad:
            new.requires_grad_(True)
        self._rebind(new)

    def _rebind(self, t):
        """Give this root a new tensor (its views follow). An attached
        leaf's old tensor stays a gradient target while a graph holds
        it."""
        old = self._t
        if self._grad is not None and old.is_leaf and old.requires_grad:
            vers = [r for r in (self._vers or ()) if r() is not None]
            vers.append(weakref.ref(old))
            self._vers = vers
        self._alias = None
        self._t = t

    def _leaf_tensors(self):
        """The tensors whose gradients make up ``grad``: the current one
        when it is a leaf on the tape (or an attached intermediate), and
        every earlier leaf a graph still holds."""
        out = [t for t in (r() for r in (self._vers or ())) if t is not None]
        t = self._t
        if t.requires_grad and (t.is_leaf or not out):
            out.append(t)
        return out

    def _settle(self):
        """After a backward that freed its graph: an attached array is a
        leaf again (its current value), with no earlier versions."""
        self._vers = None
        t = self._t
        if t.grad_fn is not None:
            self._t = t.detach().requires_grad_(True)

    def _write(self, idx, value):
        """A user's write of ``value`` at ``idx`` (None: everywhere) into
        this array (module docstring: the tape and the aliases)."""
        root, path = self._root_path()
        rt = root._t
        v = _as_value(value, rt)
        tracked_v = isinstance(v, torch.Tensor) and v.requires_grad
        if autograd.is_recording() and (rt.requires_grad or tracked_v):
            with torch.enable_grad():
                new = rt.clone()
                _assign_path(new, path, idx, v)
            root._rebind(new)
            return
        if rt.requires_grad and (not rt.is_leaf or _held(rt)):
            with torch.no_grad():
                new = rt.detach().clone()
                _assign_path(new, path, idx, v)
            if rt.is_leaf:
                new.requires_grad_(True)
            root._rebind(new)
            return
        root._cow()  # may give the root a tensor of its own
        with torch.no_grad():
            _assign_path(root._t, path, idx, v)

    def _set_data(self, value):
        """Overwrite the contents in place (never recorded): how an
        operator writes back state (BatchNorm's running statistics,
        ``out=``, an optimizer's update). The other arrays sharing the
        storage get their own copy first."""
        _check_held(self._t)
        self._root()._cow()
        v = _as_value(value, self._t)
        with torch.no_grad():
            _assign(self._t, None, v)

    # -- copies, placement and conversion -------------------------------
    def copy(self) -> "NDArray":
        return NDArray(self._t.detach().clone(), self._ctx)

    def copyto(self, other):
        """Into an NDArray (its type kept) or to a context (a new array)."""
        if isinstance(other, NDArray):
            other._write(None, self._t.detach())
            return other
        if isinstance(other, (Context, str, torch.device)):
            ctx = Context(other)
            return NDArray(self._t.detach().to(_device(ctx), copy=True), ctx)
        raise TypeError(f"copyto does not support type {type(other)}")

    def as_in_context(self, context) -> "NDArray":
        if Context(context) == self.context:
            return self
        return self.copyto(Context(context))

    as_in_ctx = as_in_context

    def detach(self) -> "NDArray":
        """The same values, off the tape; a write to either array is not
        seen by the other."""
        out = NDArray(self._t.detach(), self._ctx)
        _join(self._root(), out)
        return out

    def astype(self, dtype, copy=True) -> "NDArray":
        dt = torch_dtype(dtype)
        if not copy and dt == self._t.dtype:
            return self
        return apply(_m.cast, self, dtype=dt)

    # -- autograd -----------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Give this array a gradient buffer ``grad``: ``"write"``
        overwrites it on every backward, ``"add"`` accumulates, ``"null"``
        takes it off the tape. An array computed under ``record()`` stays
        on its graph, so what it was computed from gets gradients too."""
        del stype
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be write, add or null; got "
                             f"{grad_req!r}")
        if isinstance(self, _View):
            raise MXNetError("attach_grad on a basic-index view: attach it "
                             "to the array it views")
        self._grad_req = grad_req
        self._vers = None
        if grad_req == "null":
            self._t = self._t.detach()
            self._grad = None
            return
        if self._t.grad_fn is None:
            self._t = self._t.detach().requires_grad_(True)
        self._grad = NDArray(torch.zeros_like(self._t,
                                              requires_grad=False),
                             self._ctx)
        autograd._register_leaf(self)

    @property
    def grad(self):
        return self._grad

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- indexing -----------------------------------------------------
    def __getitem__(self, idx):
        if _is_basic_index(idx) and not (autograd.is_recording()
                                         and self._t.requires_grad):
            return _View(self, idx)
        if isinstance(idx, NDArray):
            idx = _take_index(idx, self._t)
        elif not _is_basic_index(idx):
            idx = _index_tensor(idx, self._t.device)
        return apply(lambda t: _read(t, idx), self)

    def __setitem__(self, idx, value):
        if not _is_basic_index(idx):
            idx = _index_tensor(idx, self._t.device)
        self._write(idx, value)

    # -- arithmetic ---------------------------------------------------
    def _binop(self, fn, other, reverse=False):
        if isinstance(other, _np.ndarray):
            other = torch.from_numpy(other).to(self._t.device)
        a, b = (other, self) if reverse else (self, other)
        return apply(fn, a, b)

    def __add__(self, o):
        return self._binop(_m.broadcast_add, o)

    def __radd__(self, o):
        return self._binop(_m.broadcast_add, o, True)

    def __sub__(self, o):
        return self._binop(_m.broadcast_sub, o)

    def __rsub__(self, o):
        return self._binop(_m.broadcast_sub, o, True)

    def __mul__(self, o):
        return self._binop(_m.broadcast_mul, o)

    def __rmul__(self, o):
        return self._binop(_m.broadcast_mul, o, True)

    def __truediv__(self, o):
        return self._binop(_m.broadcast_div, o)

    def __rtruediv__(self, o):
        return self._binop(_m.broadcast_div, o, True)

    def __mod__(self, o):
        return self._binop(_m.broadcast_mod, o)

    def __rmod__(self, o):
        return self._binop(_m.broadcast_mod, o, True)

    def __pow__(self, o):
        return self._binop(_m.broadcast_power, o)

    def __rpow__(self, o):
        return self._binop(_m.broadcast_power, o, True)

    def __matmul__(self, o):
        return self._binop(_m.matmul, o)

    def __neg__(self):
        return apply(torch.neg, self)

    def __abs__(self):
        return apply(torch.abs, self)

    # comparisons return the input's floating type (1.0 / 0.0), as MXNet's
    # broadcast_equal family does (float32 for integer inputs)
    def __eq__(self, o):
        return self._binop(_m.broadcast_equal, o)

    def __ne__(self, o):
        return self._binop(_m.broadcast_not_equal, o)

    def __lt__(self, o):
        return self._binop(_m.broadcast_lesser, o)

    def __le__(self, o):
        return self._binop(_m.broadcast_lesser_equal, o)

    def __gt__(self, o):
        return self._binop(_m.broadcast_greater, o)

    def __ge__(self, o):
        return self._binop(_m.broadcast_greater_equal, o)

    def __hash__(self):
        return id(self)

    # in place: the same handle, written (``_write``)
    def _iop(self, fn, other):
        self._write(None, self._binop(fn, other))
        return self

    def __iadd__(self, o):
        return self._iop(_m.broadcast_add, o)

    def __isub__(self, o):
        return self._iop(_m.broadcast_sub, o)

    def __imul__(self, o):
        return self._iop(_m.broadcast_mul, o)

    def __itruediv__(self, o):
        return self._iop(_m.broadcast_div, o)


class _View(NDArray):
    """A basic-index view: ``base[index]``, read through the base at
    every use, so it follows the base when the base takes a new tensor
    (copy on write, a recorded write) and writes land in the base."""

    __slots__ = ("_base", "_index", "_src", "_tv", "_flipped")

    def __init__(self, base: NDArray, index):  # noqa: super-init-not-called
        self._base = base
        self._index = index
        # a negative step reads a flipped copy: never cached, and a write
        # goes back through the base (``_assign_path``)
        self._flipped = _reverses(index) or getattr(base, "_flipped", False)
        self._src = None
        self._tv = None
        self._ctx = base._ctx
        self._grad = None
        self._grad_req = "null"
        self._alias = None
        self._vers = None

    @property
    def _t(self):
        src = self._base._t
        if src.requires_grad or self._flipped:  # never cached
            return _read(src, self._index)
        if src is not self._src:
            self._tv = src[self._index]
            self._src = src
        return self._tv

    def _root(self):
        return self._base._root()

    def _root_path(self):
        root, path = self._base._root_path()
        return root, path + [self._index]


def _rebuild(arr, devtype, devid):
    ctx = Context(devtype, devid)
    return NDArray(torch.from_numpy(_np.array(arr)).to(_device(ctx)), ctx)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An NDArray from an NDArray, numpy array or nested list. A list
    (anything without a dtype) becomes float32 and float64 becomes
    float32, unless ``dtype`` says otherwise; ``ctx`` defaults to the
    current context (the first CUDA card)."""
    if isinstance(source_array, NDArray):
        t = source_array._t.detach()
    else:
        a = _np.asarray(source_array)
        if dtype is None and (a.dtype == _np.float64
                              or not hasattr(source_array, "dtype")):
            a = a.astype(_np.float32)
        t = torch.from_numpy(a if a.flags.c_contiguous and a.flags.writeable
                             else a.copy())
    ctx = Context(ctx) if ctx is not None else current_context()
    t = t.to(device=_device(ctx), dtype=torch_dtype(dtype) if dtype
             else None, copy=True)
    return NDArray(t, ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _filled(fill, shape, ctx, dtype):
    """``shape`` filled with ``fill`` on ``ctx`` (the current context by
    default)."""
    ctx = Context(ctx) if ctx is not None else current_context()
    return NDArray(torch.full(_shape(shape), fill,
                              dtype=torch_dtype(dtype or "float32"),
                              device=_device(ctx)), ctx)


def zeros(shape, ctx=None, dtype="float32", **kw) -> NDArray:
    return _filled(0, shape, ctx, dtype)


def ones(shape, ctx=None, dtype="float32", **kw) -> NDArray:
    return _filled(1, shape, ctx, dtype)


def full(shape, val, ctx=None, dtype="float32", **kw) -> NDArray:
    return _filled(val, shape, ctx, dtype)


def empty(shape, ctx=None, dtype="float32") -> NDArray:
    """Zeros, as in the JAX package (torch's uninitialised memory would
    make results depend on what the allocator last held)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    dt = torch_dtype(dtype or "float32")
    r = torch.arange(start, stop, step, dtype=torch.float64).to(dt)
    if repeat != 1:
        r = torch.repeat_interleave(r, repeat)
    return NDArray(r.to(_device(ctx)))


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    M = M if M > 0 else N
    r = torch.ones(N, M, dtype=torch_dtype(dtype or "float32")).triu(k) \
        .tril(k)
    return NDArray(r.to(_device(ctx)))


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    dt = torch_dtype(dtype or "float32")
    if endpoint:
        r = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        r = torch.linspace(start, stop, num + 1, dtype=torch.float64)[:num]
    return NDArray(r.to(dt).to(_device(ctx)))


def zeros_like(a, **kw):
    return NDArray(torch.zeros_like(a._t, requires_grad=False))


def ones_like(a, **kw):
    return NDArray(torch.ones_like(a._t, requires_grad=False))


def concatenate(arrays, axis=0, always_copy=True):
    return NDArray(torch.cat([a._t.detach() for a in arrays], dim=axis))


def imdecode(buf, flag=1, to_rgb=True, out=None, **kw):
    """Decode image bytes into an HWC uint8 host NDArray (Pillow;
    ``mx.image.imdecode``)."""
    from ..image.image import imdecode as _imdecode

    return _imdecode(buf, flag=flag, to_rgb=to_rgb, out=out)


def waitall():
    """Wait for all queued device work (a CUDA sync, where deferred
    device errors surface); nothing to wait for on the CPU."""
    from .. import engine

    engine.waitall()


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


# the operators the methods use (imported last: they import this module)
from ..ops import math as _m  # noqa: E402
from ..ops import shape_ops as _s  # noqa: E402
