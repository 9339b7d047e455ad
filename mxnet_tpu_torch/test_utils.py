"""Testing utilities (reference: ``python/mxnet/test_utils.py``).

PyTorch counterpart of ``mxnet_tpu/test_utils.py``: tolerance-aware
comparison, random shapes and dense arrays, seeding (numpy, Python and
``mx.random``), the central-difference gradient check and the
cross-context consistency check. ``check_symbolic_*`` need the symbol
layer (ROADMAP A13).
"""

from __future__ import annotations

import functools
import random as _pyrandom

import numpy as _np
import torch

from . import autograd
from .base import MXNetError
from .context import current_context
from .ndarray.ndarray import NDArray, array as _array

_DEFAULT_CTX = [None]


def default_context():
    return _DEFAULT_CTX[0] or current_context()


def set_default_context(ctx):
    _DEFAULT_CTX[0] = ctx


_DTYPE_TOL = {
    _np.dtype(_np.float16): (1e-2, 1e-2),
    _np.dtype(_np.float32): (1e-4, 1e-5),
    _np.dtype(_np.float64): (1e-6, 1e-8),
}


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() \
            if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return _np.asarray(x)


def get_tolerance(arr, rtol=None, atol=None):
    d = getattr(arr, "dtype", _np.float32)
    try:
        d = _np.dtype(d)
    except TypeError:  # torch.bfloat16
        d = _np.dtype(_np.float16)
    base = _DTYPE_TOL.get(d, (1e-4, 1e-5))
    return (rtol if rtol is not None else base[0],
            atol if atol is not None else base[1])


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """Per-dtype tolerance comparison (reference: ``assert_almost_equal``)."""
    a_np, b_np = _as_np(a), _as_np(b)
    rtol, atol = get_tolerance(a_np, rtol, atol)
    _np.testing.assert_allclose(
        a_np.astype(_np.float64), b_np.astype(_np.float64),
        rtol=rtol, atol=atol, equal_nan=equal_nan,
        err_msg=f"{names[0]} vs {names[1]} mismatch")


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    try:
        assert_almost_equal(a, b, rtol, atol, equal_nan=equal_nan)
        return True
    except AssertionError:
        return False


def same(a, b):
    return _np.array_equal(_as_np(a), _as_np(b))


def rand_shape_nd(ndim, dim=10):
    return tuple(_np.random.randint(1, dim + 1, size=ndim))


def rand_shape_2d(dim0=10, dim1=10):
    return (_np.random.randint(1, dim0 + 1), _np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (_np.random.randint(1, dim0 + 1), _np.random.randint(1, dim1 + 1),
            _np.random.randint(1, dim2 + 1))


def rand_ndarray(shape, stype="default", density=None, dtype="float32",
                 ctx=None, scale=1.0):
    """Uniform values in ``[-scale, scale)`` from numpy's global stream;
    dense only (sparse storage is ROADMAP A13's)."""
    if stype != "default":
        raise MXNetError(f"rand_ndarray(stype={stype!r}): sparse storage "
                         "is not in the port yet (ROADMAP A13)")
    return _array(_np.random.uniform(-scale, scale, size=shape)
                  .astype(dtype), ctx=ctx or default_context())


def random_seed(seed=None):
    """Seed numpy, Python and ``mx.random`` with one seed (a random one
    when None); returns it."""
    from . import random as mxrandom

    seed = seed or _np.random.randint(0, 2 ** 31)
    _np.random.seed(seed)
    _pyrandom.seed(seed)
    mxrandom.seed(seed)
    return seed


def with_seed(seed=None):
    """Reproducible-per-test decorator (reference:
    ``tests/python/unittest/common.py:with_seed``)."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            used = random_seed(seed)
            try:
                return fn(*args, **kwargs)
            except Exception:
                print(f"Test {fn.__name__} failed with seed {used}; "
                      f"reproduce with with_seed({used})")
                raise

        return wrapper

    return decorator


def check_numeric_gradient(fn, inputs, grads=None, eps=1e-4, rtol=1e-2,
                           atol=1e-4):
    """Central differences against the tape's gradient of ``fn(*inputs)``
    summed (reference: ``check_numeric_gradient``). Non-float inputs are
    constants; the perturbed sums are taken on the host in float64, so the
    unperturbed elements' rounding cancels."""
    arrays = [a if isinstance(a, NDArray) else _array(a, ctx=default_context())
              for a in inputs]
    is_float = [a.data.is_floating_point() for a in arrays]
    for a, fl in zip(arrays, is_float):
        if fl:
            a.attach_grad()
    with autograd.record():
        out = fn(*arrays)
    out.backward()
    analytic = [a.grad.asnumpy() if fl else None
                for a, fl in zip(arrays, is_float)]

    def f64_sum():
        with autograd.pause():
            return float(fn(*arrays).asnumpy().astype(_np.float64).sum())

    for idx, a in enumerate(arrays):
        if not is_float[idx]:
            continue
        base = a.asnumpy().astype(_np.float64)
        num = _np.zeros_like(base)
        flat = base.reshape(-1)
        num_flat = num.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            a._set_data(base.astype(a.dtype))
            fp = f64_sum()
            flat[i] = orig - eps
            a._set_data(base.astype(a.dtype))
            fm = f64_sum()
            flat[i] = orig
            a._set_data(base.astype(a.dtype))
            num_flat[i] = (fp - fm) / (2 * eps)
        _np.testing.assert_allclose(analytic[idx], num, rtol=rtol, atol=atol,
                                    err_msg=f"gradient mismatch for input {idx}")


def check_consistency(fn, ctx_list, inputs, rtol=None, atol=None):
    """Run the same function on several contexts and compare (reference:
    ``check_consistency``; here the card against the host)."""
    results = []
    for ctx in ctx_list:
        ctx_inputs = [i.as_in_context(ctx) if isinstance(i, NDArray)
                      else _array(i, ctx=ctx) for i in inputs]
        results.append(_as_np(fn(*ctx_inputs)))
    for r in results[1:]:
        rt, at = get_tolerance(results[0], rtol, atol)
        _np.testing.assert_allclose(results[0].astype(_np.float64),
                                    r.astype(_np.float64), rtol=rt, atol=at)
    return results


def simple_forward(block, *inputs):
    out = block(*[_array(i, ctx=default_context())
                  if not isinstance(i, NDArray) else i for i in inputs])
    return out.asnumpy() if isinstance(out, NDArray) \
        else [o.asnumpy() for o in out]


def check_symbolic_forward(*args, **kwargs):
    raise MXNetError("check_symbolic_forward needs the symbol/ layer "
                     "(ROADMAP A13)")


def check_symbolic_backward(*args, **kwargs):
    raise MXNetError("check_symbolic_backward needs the symbol/ layer "
                     "(ROADMAP A13)")
