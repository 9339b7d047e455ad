"""Port parity: ``gluon/data/shape_guard.py`` of ``mxnet_tpu_torch``
against the JAX package's, on the CPU.

``pad_batch`` (first-row repetition, the validity mask), ``pad_to_shape``
and ``SequenceBucketer`` on the same seeded numpy inputs, and on each
package's NDArray (and a ``torch.Tensor`` in the port): the padded arrays
and masks must be equal, exactly, with the same dtypes and shapes, and the
same inputs must raise in both.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.data import shape_guard as jsg
from mxnet_tpu_torch.gluon.data import shape_guard as tsg

KW = {"ctx": mx.cpu()}
RS = np.random.RandomState(0)
X = RS.rand(3, 5, 2).astype(np.float32)
IDS = RS.randint(1, 50, (2, 7)).astype(np.int32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.array(a.asnumpy()) if hasattr(a, "asnumpy") else np.asarray(a)


def _as(kind, a):
    """``a`` as the JAX package's and the port's input of ``kind``."""
    if kind == "numpy":
        return a, a
    if kind == "ndarray":
        return (jmx.nd.array(a, dtype=a.dtype.name),
                mx.nd.array(a, dtype=a.dtype.name, **KW))
    return jmx.nd.array(a, dtype=a.dtype.name), torch.from_numpy(a.copy())


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["numpy", "ndarray", "tensor"])
def test_pad_batch_matches_jax(kind):
    j, t = _as(kind, X)
    (jp, jmask), (tp, tmask) = jsg.pad_batch(j, 5), tsg.pad_batch(t, 5)
    assert type(tp) is type(t)
    _same(tp, jp)
    _same(tmask, jmask)
    np.testing.assert_array_equal(_np(tp)[3:], np.repeat(X[:1], 2, 0))
    # nested [data, label] structure is kept, each leaf padded
    jl, tl = _as(kind, IDS[0, :3])
    (jd, jlab), _ = jsg.pad_batch([j, jl], 4)
    (td, tlab), _ = tsg.pad_batch([t, tl], 4)
    _same(td, jd)
    _same(tlab, jlab)
    assert tsg.pad_batch(t, 3)[0] is t  # a full batch is returned as is


@pytest.mark.parametrize("case", ["too_many", "empty", "disagree"])
def test_pad_batch_refusals_match_jax(case):
    args = {"too_many": (X, 2), "empty": (X[:0], 4),
            "disagree": ([X, IDS], 4)}[case]
    with pytest.raises(jmx.base.MXNetError):
        jsg.pad_batch(*args)
    with pytest.raises(mx.MXNetError):
        tsg.pad_batch(*args)


@pytest.mark.parametrize("kind", ["numpy", "ndarray", "tensor"])
def test_pad_to_shape_matches_jax(kind):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    j, t = _as(kind, a)
    for target, value in (((2, 5), 0), ((4, 3), 7), ((3, 4), -1.5),
                          ((2, 3), 0)):
        _same(tsg.pad_to_shape(t, target, pad_value=value),
              jsg.pad_to_shape(j, target, pad_value=value))
    ji, ti = _as(kind, IDS)
    _same(tsg.pad_to_shape(ti, (2, 16)), jsg.pad_to_shape(ji, (2, 16)))
    for bad in ((2, 3, 1), (2, 2)):  # rank mismatch; truncation
        with pytest.raises(jmx.base.MXNetError):
            jsg.pad_to_shape(j, bad)
        with pytest.raises(mx.MXNetError):
            tsg.pad_to_shape(t, bad)


@pytest.mark.parametrize("kind", ["numpy", "ndarray", "tensor"])
def test_sequence_bucketer_matches_jax(kind):
    jb, tb = jsg.SequenceBucketer([16, 8, 32, 8]), \
        tsg.SequenceBucketer([16, 8, 32, 8])
    assert tb.buckets == jb.buckets == (8, 16, 32)
    for n in (1, 7, 8, 9, 31, 32):
        assert tb.bucket_for(n) == jb.bucket_for(n)
    j, t = _as(kind, RS.randint(1, 9, (2, 11)).astype(np.int32))
    (jp, jn), (tp, tn) = jb(j), tb(t)
    assert tn == jn == 11
    _same(tp, jp)
    jx, tx = _as(kind, X)
    ax2 = (jsg.SequenceBucketer([4, 6], axis=2, pad_value=-1),
           tsg.SequenceBucketer([4, 6], axis=2, pad_value=-1))
    _same(ax2[1](tx)[0], ax2[0](jx)[0])
    with pytest.raises(jmx.base.MXNetError, match="largest bucket"):
        jb.bucket_for(33)
    with pytest.raises(mx.MXNetError, match="largest bucket"):
        tb.bucket_for(33)
    for bad in ([], [0, 4]):
        with pytest.raises(mx.MXNetError):
            tsg.SequenceBucketer(bad)


def test_gluon_data_exports_the_guard_only():
    """The guard came first (with serving); the data path (ROADMAP A6)
    followed, so ``gluon.data`` now exports the JAX package's names, and
    the guard's ``pad_to_shape`` besides."""
    ours = {n for n in dir(mx.gluon.data) if not n.startswith("_")}
    theirs = {n for n in dir(jmx.gluon.data) if not n.startswith("_")}
    assert ours == theirs | {"pad_to_shape"}
    assert {"SequenceBucketer", "pad_batch", "pad_to_shape",
            "shape_guard"} <= ours
