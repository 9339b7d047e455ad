"""Port parity: ``gluon.utils`` against the JAX package's
(``mxnet_tpu/gluon/utils.py``): ``split_data`` (even and uneven),
``split_and_load`` (contexts and values), ``clip_global_norm`` (the norm
within 1e-6 relative, the scaled arrays within 1e-6: the sums of squares
are float32 in both, added in another order), ``check_sha1``,
``download`` (raises the same error without touching the network) and
``shape_is_known``."""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import hashlib

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

PKGS = ((jmx, {}), (mx, {"ctx": mx.cpu()}))


def _np(a):
    return np.array(a.asnumpy())


@pytest.mark.parametrize("rows,n,even", [(6, 3, True), (7, 3, False),
                                         (8, 4, False)])
def test_split_data(rows, n, even):
    x = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
    got = [[_np(p) for p in m.gluon.utils.split_data(
        m.nd.array(x, **kw), n, even_split=even)] for m, kw in PKGS]
    assert [p.shape for p in got[0]] == [p.shape for p in got[1]]
    for a, b in zip(*got):
        np.testing.assert_array_equal(b, a)


def test_split_data_uneven_raises_like_jax():
    x = np.zeros((7, 2), np.float32)
    for m, kw in PKGS:
        with pytest.raises(m.MXNetError, match="evenly split"):
            m.gluon.utils.split_data(m.nd.array(x, **kw), 3)


def test_split_and_load():
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    got = []
    for m, _ in PKGS:
        parts = m.gluon.utils.split_and_load(x, [m.cpu(0), m.cpu(1)],
                                             batch_axis=1)
        got.append([(str(p.context), _np(p)) for p in parts])
        one = m.gluon.utils.split_and_load(x, [m.cpu(1)])
        assert len(one) == 1 and str(one[0].context) == "cpu(1)"
    for (ca, a), (cb, b) in zip(*got):
        assert ca == cb
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm(max_norm):
    rs = np.random.RandomState(0)
    xs = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    norms, outs = [], []
    for m, kw in PKGS:
        arrs = [m.nd.array(a, **kw) for a in xs]
        norms.append(m.gluon.utils.clip_global_norm(arrs, max_norm))
        outs.append([_np(a) for a in arrs])
    np.testing.assert_allclose(norms[1], norms[0], rtol=1e-6)
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_clip_global_norm_warns_on_nan():
    for m, kw in PKGS:
        with pytest.warns(UserWarning, match="nan or inf"):
            m.gluon.utils.clip_global_norm(
                [m.nd.array(np.array([np.nan], np.float32), **kw)], 1.0)


def test_check_sha1(tmp_path):
    path = tmp_path / "blob.bin"
    data = bytes(range(256)) * 5000
    path.write_bytes(data)
    digest = hashlib.sha1(data).hexdigest()
    for m, _ in PKGS:
        assert m.gluon.utils.check_sha1(str(path), digest)
        assert not m.gluon.utils.check_sha1(str(path), "0" * 40)


def test_download_raises_like_jax():
    for m, _ in PKGS:
        with pytest.raises(m.MXNetError, match="no network egress"):
            m.gluon.utils.download("http://example.invalid/x.params",
                                   path="/nonexistent", sha1_hash="0",
                                   retries=1)


@pytest.mark.parametrize("shape", [None, (2, 3), (2, 0), (0,), (2, None),
                                   ()])
def test_shape_is_known(shape):
    assert mx.gluon.utils.shape_is_known(shape) == \
        jmx.gluon.utils.shape_is_known(shape)
