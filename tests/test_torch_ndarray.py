"""Port parity: ``NDArray`` of ``mxnet_tpu_torch`` against the JAX
package's, on the CPU.

- ``tests/test_ndarray.py``'s cases run through both packages on the same
  numpy inputs (seed 0); values must agree within 1e-6 relative and
  absolute (float32; the same elementary operations on both sides).
- C9: ``+=``, ``-=``, ``*=``, ``/=`` keep the handle and write into it,
  through a basic-index view into its base, with the reference's values.
- C11: a write through an NDArray is seen by exactly the arrays that see
  it in the JAX package. Every op of the port that can return a torch
  view of its input is walked in both directions (a write to the result,
  then a write to the source) in both packages, and the two visibility
  patterns must be equal.
- Every name of the reference's ``_METHODS`` is an NDArray method in the
  port, and every public NDArray method of the reference exists.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import pickle

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ndarray import _METHODS as JAX_METHODS

KW = {"ctx": mx.cpu()}
TOL = 1e-6


def _arr(mod, a, **kw):
    return mod.nd.array(a, **(KW if mod is mx else {}), **kw)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=tol, atol=tol)


def _both(fn):
    """``fn(mod)`` for the JAX package and the port."""
    return fn(jmx), fn(mx)


def test_creation_matches_jax():
    def run(mod):
        ctx = KW if mod is mx else {}
        return [mod.nd.zeros((2, 3), **ctx), mod.nd.ones((4,), dtype="int32",
                                                         **ctx),
                mod.nd.full((2, 2), 7.0, **ctx),
                mod.nd.array([[1, 2], [3, 4]], **ctx),
                mod.nd.arange(0, 10, 2, **ctx),
                mod.nd.arange(5, **ctx),
                mod.nd.arange(0, 3, 1, repeat=2, **ctx),
                mod.nd.eye(3, 4, 1, **ctx), mod.nd.eye(2, **ctx),
                mod.nd.linspace(0, 1, 5, **ctx),
                mod.nd.linspace(0, 1, 4, endpoint=False, **ctx),
                mod.nd.empty((2, 2), **ctx)]

    for j, t in zip(*_both(run)):
        assert t.shape == j.shape and str(t.dtype) == str(j.dtype)
        _close(t.asnumpy(), j.asnumpy())
    a = np.random.RandomState(0).rand(3, 3).astype(np.float32)
    for mod in (jmx, mx):
        x = _arr(mod, a)
        assert (mod.nd.zeros_like(x).asnumpy() == 0).all()
        assert (mod.nd.ones_like(x).asnumpy() == 1).all()
        c = mod.nd.concatenate([x, x], axis=1)
        assert c.shape == (3, 6)


def test_arithmetic_matches_jax():
    rs = np.random.RandomState(0)
    a_np = rs.rand(2, 3).astype(np.float32) + 0.5
    b_np = rs.rand(2, 3).astype(np.float32) + 0.5

    def run(mod):
        a, b = _arr(mod, a_np), _arr(mod, b_np)
        return [a + b, a - b, a * b, b / a, a + 1, 2 * a, 2 - a, a ** 2,
                2 ** a, -a, abs(-a), a % 0.3, 1.7 % a, a @ b.T, a / 3,
                3 / a, a == b, a != a, a < b, a <= b, a > b, a >= a]

    for j, t in zip(*_both(run)):
        _close(t.asnumpy(), j.asnumpy())


def test_inplace_keeps_the_handle_and_writes_c9():
    """C9: ``b = a; a += 1`` makes ``b`` read ``[2 2 2]`` (the port made a
    new handle and ``b`` read ``[1 1 1]``)."""
    def run(mod):
        ctx = KW if mod is mx else {}
        a = mod.nd.ones((3,), **ctx)
        b = a
        a += 1
        assert b is a
        out = [b.asnumpy().copy()]
        a *= 3
        a -= 1
        a /= 2
        out.append(b.asnumpy().copy())
        w = mod.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), **ctx)
        v = w[0]
        v += 10
        out.append(w.asnumpy().copy())
        v *= 2
        out.append(w.asnumpy().copy())
        return out

    j, t = _both(run)
    _close(t[0], [2, 2, 2])
    for a, b in zip(t, j):
        _close(a, b)


def test_view_aliasing_matches_jax():
    def run(mod):
        a = _arr(mod, np.arange(10, dtype=np.float32))
        b = a[2:5]
        b[:] = 0
        out = [a.asnumpy().copy()]
        a[3] = 99
        out.append(float(b[1].asscalar()))
        c = a[1:8][2:4]  # a view of a view
        c[:] = -1
        out.append(a.asnumpy().copy())
        m = _arr(mod, np.arange(12, dtype=np.float32).reshape(3, 4))
        r = m[1]
        m[1, 2] = 50
        out.append(r.asnumpy().copy())
        return out

    j, t = _both(run)
    for a, b in zip(t, j):
        _close(a, b)


def test_setitem_and_indexing_match_jax():
    np_a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)

    def run(mod):
        a = _arr(mod, np_a)
        out = [a[0], a[1, 2], a[:, 1:3], a[0, :, ::2], a[..., 1],
               a[:, None, 1]]
        idx = _arr(mod, np.array([1, 0, 1], np.float32))
        out.append(a[idx])
        z = (mod.nd.zeros((3, 3), **KW) if mod is mx
             else mod.nd.zeros((3, 3)))
        z[1] = 1.0
        z[0, 2] = 5.0
        z[2, :] = _arr(mod, np.array([7.0, 8.0, 9.0], np.float32))
        z[:, 0] = np.array([4.0, 5.0, 6.0], np.float32)
        out.append(z)
        return [o.asnumpy() for o in out]

    for j, t in zip(*_both(run)):
        _close(t, j)


def test_reshape_codes_and_methods_match_jax():
    np_a = np.random.RandomState(1).rand(2, 3, 4).astype(np.float32)
    shapes = [(6, 4), (-1,), (0, -1), (-2,), (-3, 4), (2, -4, 1, 3, 4),
              (0, 0, -1), (-4, 1, 2, -2)]

    def run(mod):
        a = _arr(mod, np_a)
        out = [a.reshape(s) for s in shapes]
        out.append(a.reshape(6, 4))
        out.append(a.reshape(shape=(4, 6)))
        out.append(mod.nd.reshape(a, shape=(-1, 4), reverse=True))
        m = _arr(mod, np.array([[1.0, 2.0], [3.0, 4.0]], np.float32))
        out += [m.sum(), m.sum(axis=0), m.mean(axis=1), m.max(), m.T,
                m.flatten(), m.expand_dims(0), m.clip(a_min=1.5, a_max=3.5),
                m.argmax(axis=1), m.exp(), m.sqrt(), m.softmax(),
                m.topk(k=1), m.sort(axis=0, is_ascend=False),
                m.tile(reps=(2, 1)), m.repeat(repeats=2, axis=1),
                m.one_hot(depth=5), m.swapaxes(0, 1), m.flip(axis=1),
                m.norm(), m.prod(), m.slice_axis(axis=1, begin=1, end=2),
                m.take(_arr(mod, np.array([1], np.float32))),
                m.pick(_arr(mod, np.array([0, 1], np.float32)), axis=1),
                m.diag(), m.broadcast_to(shape=(2, 2)), m.log_softmax(),
                m.relu(), m.sigmoid(), m.abs(), m.square(), m.nansum(),
                m.argsort(), m.min(), m.argmin()]
        return [o.asnumpy() for o in out]

    for j, t in zip(*_both(run)):
        _close(t, j)


def test_astype_copy_and_scalars_match_jax():
    for mod in (jmx, mx):
        a = mod.nd.ones((2, 2), **(KW if mod is mx else {}))
        assert str(a.astype("float16").dtype) == "float16"
        assert a.astype(np.float32, copy=False) is a
        s = _arr(mod, [3.5])
        assert s.asscalar() == pytest.approx(3.5)
        assert s.item() == pytest.approx(3.5)
        assert float(s) == pytest.approx(3.5)
        assert int(_arr(mod, np.array([7], np.int32))) == 7
        assert [1, 2, 3][_arr(mod, np.array([1], np.int32))] == 2
        with pytest.raises(ValueError):
            mod.nd.ones((2,), **(KW if mod is mx else {})).asscalar()
        assert len(mod.nd.ones((4, 2), **(KW if mod is mx else {}))) == 4
        assert bool(s)
        with pytest.raises(ValueError):
            bool(mod.nd.ones((2,), **(KW if mod is mx else {})))
        rows = list(_arr(mod, np.arange(6, dtype=np.float32).reshape(3, 2)))
        assert len(rows) == 3 and rows[2].asnumpy().tolist() == [4.0, 5.0]
        assert np.asarray(s).tolist() == [3.5]
        assert a.stype == "default" and a.tostype("default") is a
        a.wait_to_read()
        a.wait_to_write()
    with pytest.raises(mx.MXNetError, match="A13"):
        mx.nd.ones((2,), **KW).tostype("csr")
    # the data path (ROADMAP A6) is ported: imdecode decodes as the JAX
    # package's does, and refuses bytes that are no image as Pillow does
    png = jmx.image.imencode(np.arange(12, dtype=np.uint8).reshape(2, 2, 3),
                             img_fmt=".png")
    np.testing.assert_array_equal(mx.nd.imdecode(png).asnumpy(),
                                  jmx.nd.imdecode(png).asnumpy())
    with pytest.raises(OSError):
        mx.nd.imdecode(b"")


def test_copies_and_contexts():
    a = mx.nd.ones((2, 2), **KW)
    b = mx.nd.zeros((2, 2), **KW)
    assert a.copyto(b) is b and (b.asnumpy() == 1).all()
    assert a.as_in_context(mx.cpu()) is a and a.as_in_ctx(mx.cpu()) is a
    c = a.copyto(mx.cpu())
    c[:] = 5
    assert (a.asnumpy() == 1).all()
    d = a.copy()
    d += 1
    assert (a.asnumpy() == 1).all() and (d.asnumpy() == 2).all()
    h = mx.nd.array(np.arange(3, dtype=np.float32), **KW)
    i = mx.nd.zeros((3,), dtype="int32", **KW)
    h.copyto(i)
    assert i.asnumpy().dtype == np.int32 and i.asnumpy().tolist() == [0, 1, 2]


def test_pickle_round_trips():
    for mod in (jmx, mx):
        a = _arr(mod, np.array([[1.0, 2.0]], np.float32))
        b = pickle.loads(pickle.dumps(a))
        _close(b.asnumpy(), a.asnumpy())
        assert b.context == a.context


def test_waitall_and_engine():
    a = mx.nd.ones((100, 100), **KW)
    b = a @ a
    b.wait_to_read()
    mx.nd.waitall()
    assert mx.engine.wait([b, {"x": b.data}]) is not None
    mx.engine.waitall()
    assert mx.engine.set_bulk_size(30) == 15
    with mx.engine.bulk(5):
        assert mx.engine._BULK["size"] == 5
    assert mx.engine.set_bulk_size(15) == 30
    assert mx.num_gpus() == mx.num_tpus() >= 0
    assert mx.cpu_pinned(0).device_type == "cpu_pinned"
    x = mx.nd.ones((2,), ctx=mx.cpu_pinned())
    assert x.data.device.type == "cpu"


def test_sync_exec_waits_after_every_op(monkeypatch):
    from mxnet_tpu_torch import engine
    from mxnet_tpu_torch.ops import dispatch

    seen = []
    monkeypatch.setenv("MXTPU_SYNC_EXEC", "1")
    monkeypatch.setattr(engine, "wait", lambda t: seen.append(t) or t)
    r = dispatch.invoke("broadcast_add", mx.nd.ones((2,), **KW), 1.0)
    assert seen and seen[0] is r
    monkeypatch.setenv("MXTPU_SYNC_EXEC", "0")
    dispatch.invoke("exp", mx.nd.ones((2,), **KW))
    assert len(seen) == 1


# ---------------------------------------------------------------------------
# C11: which arrays see a write
# ---------------------------------------------------------------------------

def _view_ops(mod):
    """name -> (fn(c) -> result array). Each can return a torch view of
    its input in the port."""
    nd = mod.nd
    return {
        "reshape_method": lambda c: c.reshape((3, 4)),
        "nd.reshape": lambda c: nd.reshape(c, shape=(4, 3)),
        "reshape_like": lambda c: nd.reshape_like(
            c, nd.zeros((12,), **(KW if mod is mx else {}))),
        "flatten": lambda c: nd.flatten(c),
        "expand_dims": lambda c: nd.expand_dims(c, axis=0),
        "squeeze": lambda c: nd.squeeze(nd.expand_dims(c, axis=1)),
        "transpose": lambda c: nd.transpose(c),
        "T": lambda c: c.T,
        "swapaxes": lambda c: nd.swapaxes(c, dim1=0, dim2=1),
        "slice_axis": lambda c: nd.slice_axis(c, axis=1, begin=1, end=3),
        "slice": lambda c: nd.slice(c, begin=(0, 1), end=(2, 4)),
        "crop": lambda c: nd.crop(c, begin=(1, 0), end=(2, 2)),
        "split": lambda c: nd.split(c, num_outputs=2, axis=1)[1],
        "split_v2": lambda c: nd.split_v2(c, indices=(1,), axis=1)[0],
        "broadcast_to": lambda c: nd.broadcast_to(
            nd.expand_dims(c, axis=0), shape=(2, 2, 6)),
        "broadcast_axis": lambda c: nd.broadcast_axis(
            nd.expand_dims(c, axis=0), axis=0, size=3),
        "diag": lambda c: nd.diag(c),
        "detach": lambda c: c.detach(),
        "stop_gradient": lambda c: nd.stop_gradient(c),
        "BlockGrad": lambda c: nd.BlockGrad(c),
        "SequenceLast": lambda c: nd.SequenceLast(c),
        "identity_with_attr_like_rhs": lambda c: nd.identity_with_attr_like_rhs(
            c, c),
        "cast_same_type": lambda c: nd.cast(c, dtype="float32"),
        "astype_copy": lambda c: c.astype("float32"),
        "sum_no_axes": lambda c: nd.sum(c, axis=(0, 1), exclude=True),
        "astype_no_copy": lambda c: c.astype("float32", copy=False),
        "basic_index": lambda c: c[1],
        "basic_slice": lambda c: c[:, 2:5],
        "identity": lambda c: nd.identity(c),
    }


def _visibility(mod, name):
    """(source changed by a write to the result, result changed by a
    later write to the source)."""
    ctx = KW if mod is mx else {}
    c = mod.nd.array(np.arange(12, dtype=np.float32).reshape(2, 6), **ctx)
    d = _view_ops(mod)[name](c)
    d_before = d.asnumpy().copy()
    d[:] = -7.0
    c_after = c.asnumpy().copy()
    src_saw = not np.array_equal(c_after,
                                 np.arange(12, dtype=np.float32)
                                 .reshape(2, 6))
    d_now = d.asnumpy().copy()
    c[:] = 100.0
    res_saw = not np.array_equal(d.asnumpy(), d_now)
    assert not np.array_equal(d_before, d_now) or d_before.size == 0
    return src_saw, res_saw


@pytest.mark.parametrize("name", sorted(_view_ops(jmx)))
def test_writes_are_seen_where_jax_sees_them_c11(name):
    """C11: at c00cefc the port's reshape/flatten/expand_dims/transpose/
    slice_axis results aliased their source (a write to either showed in
    the other); the JAX package's do not."""
    want = _visibility(jmx, name)
    got = _visibility(mx, name)
    assert got == want, f"{name}: port {got}, JAX package {want}"


def test_write_to_source_keeps_every_derived_array():
    """One source, several derived arrays and a view of one of them: a
    write to the source gives each its own copy first; a write to a
    derived array leaves the others and the source alone."""
    c = mx.nd.array(np.arange(6, dtype=np.float32), **KW)
    r1, r2 = c.reshape((2, 3)), c.reshape((3, 2))
    v = r1[0]
    r1[1] = 0.0
    assert c.asnumpy().tolist() == [0, 1, 2, 3, 4, 5]
    assert r2.asnumpy().ravel().tolist() == [0, 1, 2, 3, 4, 5]
    assert r1.asnumpy().ravel().tolist() == [0, 1, 2, 0, 0, 0]
    c[:] = 9.0
    assert r2.asnumpy().ravel().tolist() == [0, 1, 2, 3, 4, 5]
    assert v.asnumpy().tolist() == [0, 1, 2]
    v[:] = 4.0
    assert r1.asnumpy().ravel().tolist() == [4, 4, 4, 0, 0, 0]
    assert (c.asnumpy() == 9).all()


def test_state_writes_keep_their_tensor():
    """The storage a state write lands in does not move: a parameter's,
    a running statistic's, a gradient buffer's tensor is the same object
    after ``_set_data``, ``out=`` and a write to a derived array."""
    w = mx.nd.array(np.ones((2, 3), np.float32), **KW)
    w.attach_grad()
    t, g = w.data, w.grad.data
    derived = w.reshape((3, 2))
    w._set_data(np.zeros((2, 3), np.float32))
    assert w.data is t and (derived.asnumpy() == 1).all()
    mx.nd.sgd_update(w, mx.nd.ones((2, 3), **KW), lr=0.5, wd=0.0, out=w)
    assert w.data is t and (w.asnumpy() == -0.5).all()
    derived[:] = 3.0
    assert w.data is t and (w.asnumpy() == -0.5).all()
    with mx.autograd.record():
        (w * w).sum().backward()
    assert w.grad.data is g and w.data is t
    w[0, 0] = 1.0  # no graph holds the leaf any more: in place
    assert w.data is t


def test_methods_cover_the_reference():
    missing = [m for m in JAX_METHODS if not hasattr(mx.nd.NDArray, m)]
    assert not missing
    jpub = {n for n in dir(jmx.nd.NDArray) if not n.startswith("_")}
    tpub = {n for n in dir(mx.nd.NDArray) if not n.startswith("_")}
    assert jpub - tpub == set()
    for name in ("asscalar", "item", "copyto", "as_in_context", "as_in_ctx",
                 "detach", "T", "copy", "wait_to_write", "stype",
                 "tostype", "__mod__", "__rpow__", "__matmul__",
                 "__reduce__", "__iadd__", "__isub__", "__imul__",
                 "__itruediv__", "__len__", "__iter__", "__array__",
                 "__bool__", "__index__", "__float__", "__int__"):
        assert hasattr(mx.nd.NDArray, name), name


def test_creation_functions_exist():
    for name in ("empty", "arange", "eye", "linspace", "zeros_like",
                 "ones_like", "concatenate", "imdecode"):
        assert callable(getattr(mx.nd, name)), name


@pytest.mark.parametrize("name", sorted(_view_ops(jmx)))
def test_writes_are_seen_where_jax_sees_them_on_cuda(name, monkeypatch):
    """C11 on the card: the same visibility as the JAX package's."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    want = _visibility(jmx, name)
    monkeypatch.setitem(KW, "ctx", mx.gpu(0))
    assert _visibility(mx, name) == want


# -- C15: basic slicing with a negative step --------------------------------

NEG_STEP_READS = {"rows": np.s_[::-1], "cols_by_2": np.s_[:, ::-2],
                  "last_row_reversed": np.s_[-1, ::-1],
                  "stop_and_int": np.s_[2:0:-1, 1],
                  "ellipsis": np.s_[..., ::-3],
                  "new_axis": np.s_[None, ::-1, 1:3]}


def _grid(mod):
    return _arr(mod, np.arange(12, dtype=np.float32).reshape(3, 4))


@pytest.mark.parametrize("key", sorted(NEG_STEP_READS))
def test_negative_step_read_matches_jax_c15(key):
    ix = NEG_STEP_READS[key]
    j, t = _both(lambda mod: _grid(mod)[ix].asnumpy())
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def test_negative_step_writes_match_jax_c15():
    """``x[::-1] = y`` writes x's rows in reverse; ``v = x[::-1]; v[0] =
    -1`` writes x's last row; a view of that view writes through both."""
    def run(mod):
        x = _grid(mod)
        x[::-1] = _arr(mod, np.arange(12, 24, dtype=np.float32)
                       .reshape(3, 4))
        y = _grid(mod)
        v = y[::-1]
        v[0] = -1
        z = _grid(mod)
        w = z[:, ::-2]
        w[1:][:] = 7
        w[0, 1] = -5
        return [x.asnumpy(), y.asnumpy(), v.asnumpy(), z.asnumpy(),
                w.asnumpy()]

    for t, j in zip(*reversed(_both(run))):
        np.testing.assert_array_equal(t, j)


def test_negative_step_gradients_match_jax_c15():
    """Under ``record()``: ``(x[::-1] * w).sum()`` gives ``x.grad ==
    w[::-1]``, and a recorded ``x[::-1] = y`` sends y the reversed head."""
    def run(mod):
        w = _arr(mod, np.arange(12, dtype=np.float32).reshape(3, 4) + 1)
        x = _grid(mod)
        x.attach_grad()
        with mod.autograd.record():
            loss = (x[::-1] * w).sum()
        loss.backward()
        a = _grid(mod)
        y = _arr(mod, np.ones((2, 4), np.float32))
        y.attach_grad()
        with mod.autograd.record():
            b = a * 1
            b[2:0:-1] = y * 3
            out = (b * w).sum()
        out.backward()
        return [x.grad.asnumpy(), b.asnumpy(), y.grad.asnumpy()]

    j, t = _both(run)
    np.testing.assert_array_equal(
        t[0], np.arange(12, dtype=np.float32).reshape(3, 4)[::-1] + 1)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


# -- C26: an NDArray key gathers along axis 0, whatever its type ----------

@pytest.mark.parametrize("case", ["vector", "matrix"])
def test_bool_ndarray_key_gathers(case):
    """The reference casts any NDArray key to int32 and ``take``s along
    axis 0, so a bool key reads rows 0 and 1; the port masked with it.
    Exact."""
    if case == "vector":
        x, key = np.arange(8, dtype=np.float32), [1, 0, 1, 0, 0, 0, 0, 1]
    else:
        x, key = np.arange(12, dtype=np.float32).reshape(3, 4), [1, 0, 1]

    def run(mod):
        kw = KW if mod is mx else {}
        a = mod.nd.array(x, **kw)
        return a[mod.nd.array(np.array(key, bool), dtype="bool",
                              **kw)].asnumpy()

    want, got = run(jmx), run(mx)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x[np.array(key)])


def test_out_of_range_ndarray_key_raises():
    """Past the axis the reference's ``jnp.take`` fills NaN; the port
    raises ``MXNetError`` (ROADMAP's traps); a negative key in range
    counts from the end in both."""
    a = mx.nd.array(np.arange(8, dtype=np.float32), **KW)
    with pytest.raises(mx.MXNetError, match="out of range"):
        a[mx.nd.array([9], dtype="int32", **KW)]
    assert np.isnan(jmx.nd.array(np.arange(8, dtype=np.float32))[
        jmx.nd.array([9], dtype="int32")].asnumpy()).all()
    np.testing.assert_array_equal(
        a[mx.nd.array([-1], dtype="int32", **KW)].asnumpy(),
        jmx.nd.array(np.arange(8, dtype=np.float32))[
            jmx.nd.array([-1], dtype="int32")].asnumpy())


# -- C27 (the reference's fault, pinned): unary minus of an integer array --

@pytest.mark.parametrize("dtype", ["int32", "uint8"])
def test_neg_of_int_array_pinned(dtype):
    """The reference's ``__neg__`` multiplies by -1.0 and gives float32;
    the port keeps the type, as MXNet 1.x does (uint8 wraps)."""
    x = np.array([1, 2], dtype)
    j = (-jmx.nd.array(x, dtype=dtype)).asnumpy()
    t = (-mx.nd.array(x, dtype=dtype, **KW)).asnumpy()
    assert j.dtype == np.float32
    np.testing.assert_array_equal(j, [-1.0, -2.0])
    assert t.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(t, np.array([-1, -2]).astype(dtype))
