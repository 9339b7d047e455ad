"""Port parity: ``mx.image`` and the ``nd.image`` operators against the JAX
package (the cases of ``tests/test_image_ops.py`` and the image cases of
``tests/test_io_recordio.py``).

Tolerances: to_tensor, normalize, crops, flips, nearest resize, the
codecs and every augmenter that only indexes or casts are held exactly.
Linear and cubic resizes are float32 weight matrices contracted in
another order (``torch.tensordot`` against ``jnp.einsum``): float
results within 2e-4 absolute on [0, 255] images, uint8 results within 1
(a rounding at .5 may fall either way). The random operators draw from
torch's stream, not ``jax.random``: a pinned factor range (min = max)
gives the same result as the reference, and the random draws are held
by their moments and by repeating under ``mx.random.seed``.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


def _img(h=8, w=6, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)).astype(
        np.uint8)


def _np(a):
    return np.array(a.asnumpy())


def _pair(arr, dtype=None):
    kw = {} if dtype is None else {"dtype": dtype}
    return mx.nd.array(arr, ctx=mx.cpu(), **kw), jmx.nd.array(arr, **kw)


def test_to_tensor_and_normalize_equal_jax():
    img = _img()
    for x in (img, np.stack([img, img[::-1]])):
        p, j = _pair(x, "uint8")
        t, jt = mx.nd.image.to_tensor(p), jmx.nd.image.to_tensor(j)
        np.testing.assert_array_equal(_np(t), _np(jt))
        kw = dict(mean=(0.1, 0.2, 0.3), std=(0.5, 0.25, 0.5))
        np.testing.assert_array_equal(_np(mx.nd.image.normalize(t, **kw)),
                                      _np(jmx.nd.image.normalize(jt, **kw)))
    assert t.shape == (2, 3, 8, 6)


@pytest.mark.parametrize("kw", [dict(size=(3, 4)), dict(size=(9, 13)),
                                dict(size=4, keep_ratio=True),
                                dict(size=5), dict(size=(3, 4), interp=0),
                                dict(size=(11, 7), interp=0),
                                dict(size=(6, 8), interp=0)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_resize_equals_jax(kw, dtype):
    img = _img(8, 6).astype(dtype)
    for x in (img, np.stack([img, img[:, ::-1]])):
        p, j = _pair(x, dtype)
        got = _np(mx.nd.image.resize(p, **kw))
        want = _np(jmx.nd.image.resize(j, **kw))
        assert got.shape == want.shape and got.dtype == want.dtype
        if kw.get("interp") == 0:
            np.testing.assert_array_equal(got, want)
        elif dtype == "uint8":
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_crop_and_flips_equal_jax():
    img = _img()
    p, j = _pair(img, "uint8")
    for name, kw in (("crop", dict(x=1, y=2, width=4, height=5)),
                     ("flip_left_right", {}), ("flip_top_bottom", {})):
        np.testing.assert_array_equal(
            _np(getattr(mx.nd.image, name)(p, **kw)),
            _np(getattr(jmx.nd.image, name)(j, **kw)))
    np.testing.assert_array_equal(_np(mx.nd.image.crop(
        p, x=1, y=2, width=4, height=5)), img[2:7, 1:5])


def test_pinned_factors_equal_jax():
    img = _img().astype(np.float32)
    batch = np.stack([img, img * 0.1])
    for x in (img, batch):
        p, j = _pair(x)
        for name, lo, hi in (("random_brightness", 1.5, 1.5),
                             ("random_contrast", 0.0, 0.0),
                             ("random_contrast", 0.7, 0.7),
                             ("random_saturation", 0.3, 0.3),
                             ("random_hue", 1.2, 1.2),
                             ("random_hue", 1.0, 1.0)):
            got = _np(getattr(mx.nd.image, name)(p, lo, hi))
            want = _np(getattr(jmx.nd.image, name)(j, lo, hi))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
        for alpha in ((0.01, 0.0, 0.0), (0.1, -0.2, 0.05)):
            np.testing.assert_allclose(
                _np(mx.nd.image.adjust_lighting(p, alpha=alpha)),
                _np(jmx.nd.image.adjust_lighting(j, alpha=alpha)),
                rtol=1e-6, atol=1e-4)
    assert _np(mx.nd.image.random_flip_left_right(p, p=1.0)).tolist() == \
        _np(jmx.nd.image.random_flip_left_right(j, p=1.0)).tolist()


def test_random_ops_by_moments_and_seed():
    x = mx.nd.array(np.full((4, 4, 3), 100.0, np.float32), ctx=mx.cpu())
    mx.random.seed(0)
    f = np.array([_np(mx.nd.image.random_brightness(x, 0.5, 1.5))[0, 0, 0]
                  / 100.0 for _ in range(2000)])
    assert abs(f.mean() - 1.0) < 0.02 and abs(f.std() - 1 / 12 ** 0.5) < 0.02
    assert f.min() >= 0.5 and f.max() <= 1.5
    flips = [_np(mx.nd.image.random_flip_left_right(
        mx.nd.array(_img(2, 2).astype(np.float32), ctx=mx.cpu())))
        for _ in range(400)]
    share = np.mean([not np.array_equal(a, flips[0]) for a in flips])
    assert 0.4 < share < 0.6
    lights = np.array([_np(mx.nd.image.random_lighting(x, alpha_std=0.1))
                       [0, 0] - 100.0 for _ in range(2000)])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    eigval = np.array([55.46, 4.794, 1.148])
    want_cov = eigvec @ np.diag((0.1 * eigval) ** 2) @ eigvec.T
    np.testing.assert_allclose(np.cov(lights.T), want_cov, rtol=0.15,
                               atol=0.05)
    img = mx.nd.array(_img().astype(np.float32), ctx=mx.cpu())
    mx.random.seed(42)
    a = _np(mx.nd.image.random_color_jitter(img, brightness=0.4,
                                            contrast=0.2, saturation=0.2,
                                            hue=0.1))
    mx.random.seed(42)
    b = _np(mx.nd.image.random_color_jitter(img, brightness=0.4,
                                            contrast=0.2, saturation=0.2,
                                            hue=0.1))
    np.testing.assert_array_equal(a, b)
    assert a.shape == img.shape


def test_registry_names_match_jax():
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry

    names = {n for n, d in jreg.all_ops().items()
             if d.fn.__module__.endswith("image_ops")} \
        if hasattr(jreg, "all_ops") else set()
    ours = {n for n, d in registry.all_ops().items()
            if d.fn.__module__.endswith("image_ops")}
    assert len({d for n, d in registry.all_ops().items()
                if n in ours}) == 15
    if names:
        assert ours == names
    for n in ours:
        assert hasattr(mx.nd, n) == hasattr(jmx.nd, n)


def test_codecs_equal_jax():
    img = _img(24, 30, seed=1)
    for fmt in (".jpg", ".png"):
        buf = mx.image.imencode(img, img_fmt=fmt)
        assert buf == jmx.image.imencode(img, img_fmt=fmt)
        for kw in (dict(), dict(flag=0), dict(to_rgb=False)):
            got = mx.image.imdecode(buf, **kw)
            assert got.context == mx.cpu() and got.dtype == np.uint8
            np.testing.assert_array_equal(_np(got),
                                          _np(jmx.image.imdecode(buf, **kw)))
        np.testing.assert_array_equal(_np(mx.nd.imdecode(buf)),
                                      _np(jmx.image.imdecode(buf)))


def test_image_functions_equal_jax():
    img = _img(30, 40, seed=2)
    p, j = _pair(img, "uint8")
    for interp in (0, 1, 2):
        got = _np(mx.image.imresize(p, 20, 10, interp))
        want = _np(jmx.image.imresize(j, 20, 10, interp))
        assert got.shape == (10, 20, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    got = _np(mx.image.resize_short(p, 20))
    assert got.shape == _np(jmx.image.resize_short(j, 20)).shape
    np.testing.assert_array_equal(_np(mx.image.fixed_crop(p, 3, 4, 16, 12)),
                                  _np(jmx.image.fixed_crop(j, 3, 4, 16, 12)))
    np.testing.assert_array_equal(_np(mx.image.center_crop(p, (16, 16))[0]),
                                  _np(jmx.image.center_crop(j, (16, 16))[0]))
    for fn, args in ((mx.image.random_crop, ((8, 8),)),
                     (mx.image.random_size_crop, ((14, 14), (0.08, 1.0),
                                                  (0.75, 4 / 3)))):
        random.seed(9)
        got, box = fn(p, *args)
        random.seed(9)
        want, jbox = getattr(jmx.image, fn.__name__)(j, *args)
        assert box == jbox
        assert np.abs(_np(got).astype(int)
                      - _np(want).astype(int)).max() <= 1
    for deg in (0, 30, -90):
        np.testing.assert_array_equal(_np(mx.image.imrotate(p, deg)),
                                      _np(jmx.image.imrotate(j, deg)))
    f, jf = _pair(img.astype(np.float32))
    mean, std = np.array([123.68, 116.28, 103.53]), np.array([58.4, 57.1,
                                                              57.4])
    np.testing.assert_allclose(_np(mx.image.color_normalize(f, mean, std)),
                               _np(jmx.image.color_normalize(jf, mean, std)),
                               rtol=1e-6, atol=1e-6)


def test_augmenters_equal_jax_from_one_seed():
    img = _img(36, 44, seed=3)
    kw = dict(resize=40, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.3, contrast=0.3, saturation=0.3)
    augs = mx.image.CreateAugmenter((3, 32, 32), **kw)
    jaugs = jmx.image.CreateAugmenter((3, 32, 32), **kw)
    assert [type(a).__name__ for a in augs] == \
        [type(a).__name__ for a in jaugs]
    for seed in (1, 2, 3):
        x, jx = _pair(img, "uint8")
        random.seed(seed)
        for a in augs:
            x = a(x)
        random.seed(seed)
        for a in jaugs:
            jx = a(jx)
        assert x.shape == jx.shape == (32, 32, 3)
        # resize_short's cubic rounding may differ by 1 on a uint8 pixel:
        # after normalisation that is 1/57 at most
        np.testing.assert_allclose(_np(x), _np(jx), rtol=0, atol=0.02)
    for cls, args in ((mx.image.ForceResizeAug, ((20, 16),)),
                      (mx.image.CenterCropAug, ((20, 16),)),
                      (mx.image.CastAug, ())):
        x, jx = _pair(img, "uint8")
        got = _np(cls(*args)(x))
        want = _np(getattr(jmx.image, cls.__name__)(*args)(jx))
        assert np.abs(got.astype(float) - want.astype(float)).max() <= 1


def test_image_iter_batches_equal_jax(tmp_path):
    from mxnet_tpu import recordio as jrec

    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(5):
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i), i, 0),
                                     _img(20, 24, seed=i)))
    w.close()
    kw = dict(batch_size=2, data_shape=(3, 16, 16), path_imgrec=rec,
              shuffle=True, rand_crop=True, rand_mirror=True)
    random.seed(4)
    got = [(_np(b.data[0]), _np(b.label[0]), b.pad)
           for b in mx.image.ImageIter(**kw)]
    random.seed(4)
    want = [(_np(b.data[0]), _np(b.label[0]), b.pad)
            for b in jmx.image.ImageIter(**kw)]
    assert len(got) == len(want) == 3 and got[-1][2] == want[-1][2] == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    with pytest.raises(mx.MXNetError, match="A13"):
        mx.image.ImageDetIter(batch_size=1, data_shape=(3, 8, 8))
