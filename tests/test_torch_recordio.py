"""Port parity: ``recordio``, ``_native`` and ``mx.io`` against the JAX
package (the cases of ``tests/test_io_recordio.py``).

- RecordIO packs, indexed packs and ``pack``/``unpack`` payloads written
  by either package are byte-identical and read back by the other.
- The native data plane is built from ``cxx/mxtpu_io.cc`` into
  ``mxnet_tpu_torch/_build/``; ``cxx/libmxtpu.so`` is left as it was
  (same bytes, or still absent) and no port module loads it.
- ``ImageRecordIter`` gives the same batches, bit for bit, in both
  packages on a small pack (one pipeline thread, so the order and the
  augmentation draws do not depend on thread scheduling); the Python
  route (an ``aug_list``) gives the same batches from one Python
  ``random`` seed. ``NDArrayIter``, ``ResizeIter``, ``CSVIter``,
  ``PrefetchingIter`` and ``MNISTIter`` batch as the reference does,
  exactly; ``LibSVMIter`` raises naming ROADMAP A13.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import ctypes
import gzip
import hashlib
import os
import random
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import recordio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED_SO = os.path.join(ROOT, "cxx", "libmxtpu.so")
PAYLOADS = [b"hello", b"x" * 1000, b"", b"abcd" * 7, bytes(range(256))]


def _np(a):
    return np.array(a.asnumpy())


@pytest.mark.parametrize("writer,reader", [(recordio, jrec), (jrec, recordio),
                                           (recordio, recordio)])
def test_recordio_files_cross_read(tmp_path, writer, reader):
    path = str(tmp_path / "t.rec")
    w = writer.MXRecordIO(path, "w")
    for p in PAYLOADS:
        w.write(p)
    w.close()
    r = reader.MXRecordIO(path, "r")
    assert [r.read() for _ in PAYLOADS] == PAYLOADS
    assert r.read() is None
    r.close()


def test_recordio_bytes_identical(tmp_path):
    files = {}
    for tag, mod in (("port", recordio), ("jax", jrec)):
        rec, idx = str(tmp_path / f"{tag}.rec"), str(tmp_path / f"{tag}.idx")
        w = mod.MXIndexedRecordIO(idx, rec, "w")
        for i, p in enumerate(PAYLOADS):
            w.write_idx(i, mod.pack(mod.IRHeader(0, float(i), i, 0), p))
        w.write_idx(9, mod.pack(mod.IRHeader(
            0, np.array([1.0, 2.5, 3.0], np.float32), 9, 4), b"multi"))
        w.close()
        files[tag] = (open(rec, "rb").read(), open(idx, "rb").read())
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("writer,reader", [(recordio, jrec), (jrec, recordio)])
def test_indexed_recordio_cross_read(tmp_path, writer, reader):
    rec, idx = str(tmp_path / "t.rec"), str(tmp_path / "t.idx")
    w = writer.MXIndexedRecordIO(idx, rec, "w")
    for i in range(10):
        w.write_idx(i, f"record{i}".encode())
    w.close()
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == list(range(10))
    assert r.read_idx(7) == b"record7" and r.read_idx(2) == b"record2"
    r.close()


def test_irheader_pack_unpack_matches_jax():
    for hdr in ((0, 3.5, 42, 0),
                (0, np.array([1.0, 2.0, 3.0], np.float32), 7, 0)):
        s = recordio.pack(recordio.IRHeader(*hdr), b"payload")
        assert s == jrec.pack(jrec.IRHeader(*hdr), b"payload")
        got, payload = recordio.unpack(s)
        want, jpayload = jrec.unpack(s)
        assert payload == jpayload == b"payload"
        assert got.flag == want.flag and got.id == want.id
        np.testing.assert_array_equal(np.asarray(got.label),
                                      np.asarray(want.label))


def test_pack_img_unpack_img_match_jax():
    img = (np.random.RandomState(1).rand(24, 30, 3) * 255).astype(np.uint8)
    hdr = recordio.IRHeader(0, 1.0, 3, 0)
    for fmt in (".jpg", ".png"):
        s = recordio.pack_img(hdr, img, quality=95, img_fmt=fmt)
        assert s == jrec.pack_img(jrec.IRHeader(*hdr), img, quality=95,
                                  img_fmt=fmt)
        _, got = recordio.unpack_img(s)
        _, want = jrec.unpack_img(s)
        np.testing.assert_array_equal(got, np.asarray(want))


def _so_hash():
    if not os.path.exists(TRACKED_SO):
        return None
    with open(TRACKED_SO, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_native_builds_into_the_port_and_leaves_cxx_alone(tmp_path):
    from mxnet_tpu_torch import _native

    before = _so_hash()
    lib = _native.get_lib()
    assert os.path.dirname(lib._name) == _native.BUILD_DIR
    assert lib._name.startswith(os.path.join(ROOT, "mxnet_tpu_torch",
                                             "_build"))
    assert _so_hash() == before
    path = str(tmp_path / "n.rec")
    w = recordio.MXRecordIO(path, "w")
    w.write(b"native-check-1")
    w.write(b"second record longer payload")
    w.close()
    h = ctypes.c_void_p()
    assert lib.MXTPURecordIOOpen(path.encode(), 0, ctypes.byref(h)) == 0
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.MXTPURecordIOReadRecord(h, ctypes.byref(ptr))
    assert bytes(bytearray(ptr[:n])) == b"native-check-1"
    n = lib.MXTPURecordIOReadRecord(h, ctypes.byref(ptr))
    assert bytes(bytearray(ptr[:n])) == b"second record longer payload"
    assert lib.MXTPURecordIOReadRecord(h, ctypes.byref(ptr)) == 0
    lib.MXTPURecordIOClose(h)


def test_native_build_failure_raises_with_compiler_output(monkeypatch,
                                                          tmp_path):
    """A source whose codec header is missing (as on a machine without
    libjpeg's headers) raises with the compiler's message, and raises
    again on the next call; nothing falls back."""
    from mxnet_tpu_torch import _native

    src = tmp_path / "cxx"
    src.mkdir()
    (src / "mxtpu_io.h").write_text("")
    (src / "mxtpu_io.cc").write_text("#include <no_such_codec.h>\n")
    monkeypatch.setattr(_native, "CXX_DIR", str(src))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_ERROR", None)
    for _ in range(2):
        with pytest.raises(mx.MXNetError, match="no_such_codec.h"):
            _native.get_lib()
    with pytest.raises(mx.MXNetError, match="no_such_codec.h"):
        mx.io.ImageRecordIter(path_imgrec=_make_image_pack(tmp_path, n=2),
                              data_shape=(3, 8, 8), batch_size=2)
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]


def test_native_decode_matches_pillow_and_jax():
    from mxnet_tpu import _native as jnative
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.image import imdecode, imencode

    img = (np.random.RandomState(1).rand(24, 30, 3) * 255).astype(np.uint8)
    for fmt in (".jpg", ".png"):
        buf = imencode(img, img_fmt=fmt)
        nat = _native.decode_image(buf)
        np.testing.assert_array_equal(nat, _np(imdecode(buf)))
        if jnative.available():
            np.testing.assert_array_equal(nat, jnative.decode_image(buf))


def _make_image_pack(tmp_path, n=12, hw=(40, 48), index=True):
    rec = str(tmp_path / "img.rec")
    idx = str(tmp_path / "img.idx")
    rng = np.random.RandomState(0)
    w = recordio.MXIndexedRecordIO(idx, rec, "w") if index \
        else recordio.MXRecordIO(rec, "w")
    for i in range(n):
        img = (rng.rand(hw[0], hw[1], 3) * 255).astype(np.uint8)
        s = recordio.pack_img(recordio.IRHeader(0, float(i % 3), i, 0), img)
        w.write_idx(i, s) if index else w.write(s)
    w.close()
    return rec


ITER_ARGS = dict(data_shape=(3, 32, 32), batch_size=5, shuffle=True,
                 rand_crop=True, rand_mirror=True, mean_r=123.68,
                 mean_g=116.28, mean_b=103.53, std_r=58.395, std_g=57.12,
                 std_b=57.375, preprocess_threads=1, seed=3)


def test_image_record_iter_native_batches_equal_jax(tmp_path):
    from mxnet_tpu import _native as jnative
    from mxnet_tpu_torch.io.io import _NativeImageRecordIter

    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")
    rec = _make_image_pack(tmp_path)
    it = mx.io.ImageRecordIter(path_imgrec=rec, **ITER_ARGS)
    jit = jmx.io.ImageRecordIter(path_imgrec=rec, **ITER_ARGS)
    assert isinstance(it, _NativeImageRecordIter)
    for epoch in range(2):
        got = [(_np(b.data[0]), _np(b.label[0]), b.pad) for b in it]
        want = [(_np(b.data[0]), _np(b.label[0]), b.pad) for b in jit]
        assert len(got) == len(want) == 3
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            assert gd.shape == (5, 3, 32, 32) and gd.dtype == np.float32
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp
        assert got[-1][2] == 3
        it.reset()
        jit.reset()


def test_image_record_iter_routes_as_the_reference(tmp_path):
    """An ``aug_list`` takes the Python ImageIter behind a
    PrefetchingIter; with the same Python ``random`` seed its batches
    equal the JAX package's (float32 within 1e-5: the normalisation's
    division order). A pack without its index takes the same route."""
    rec = _make_image_pack(tmp_path, n=6)
    aug = mx.image.CreateAugmenter((3, 24, 24), rand_crop=True,
                                   rand_mirror=True, mean=True, std=True)
    jaug = jmx.image.CreateAugmenter((3, 24, 24), rand_crop=True,
                                     rand_mirror=True, mean=True, std=True)
    random.seed(5)
    it = mx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 24, 24),
                               batch_size=4, aug_list=aug)
    assert isinstance(it, mx.io.PrefetchingIter)
    got = [(_np(b.data[0]), _np(b.label[0]), b.pad) for b in it]
    it.close()
    random.seed(5)
    jit = jmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 24, 24),
                                 batch_size=4, aug_list=jaug)
    want = [(_np(b.data[0]), _np(b.label[0]), b.pad) for b in jit]
    jit.close()
    assert len(got) == len(want) == 2 and got[1][2] == want[1][2] == 2
    for (gd, gl, _), (wd, wl, _) in zip(got, want):
        np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(gl, wl)
    # without its index a pack goes to the Python route too, whose
    # ImageIter opens the index: both packages raise the same error
    os.remove(str(tmp_path / "img.idx"))
    rec = _make_image_pack(tmp_path, n=4, index=False)
    for pkg in (mx, jmx):
        with pytest.raises(FileNotFoundError):
            pkg.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 24, 24),
                                   batch_size=2)


def test_image_record_iter_pinned_host_batches(tmp_path, monkeypatch):
    """The native iterator copies each batch out of the pipeline's reused
    buffer into a new host tensor (pinned when a card is present)."""
    rec = _make_image_pack(tmp_path, n=4)
    it = mx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                               batch_size=2, preprocess_threads=1)
    a, b = next(it), next(it)
    assert a.data[0].context == mx.cpu()
    assert a.data[0].data.data_ptr() != b.data[0].data.data_ptr()
    import torch

    assert a.data[0].data.is_pinned() == torch.cuda.is_available()


def test_ndarray_iter_matches_jax():
    data = np.arange(40, dtype=np.float32).reshape(10, 4)
    label = np.arange(10, dtype=np.float32)
    for mode, n in (("pad", 4), ("discard", 3), ("roll_over", 4)):
        it = mx.io.NDArrayIter(data, label, batch_size=3,
                               last_batch_handle=mode)
        jit = jmx.io.NDArrayIter(data, label, batch_size=3,
                                 last_batch_handle=mode)
        got, want = list(it), list(jit)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            assert g.data[0].context == mx.cpu()
            np.testing.assert_array_equal(_np(g.data[0]), _np(w.data[0]))
            np.testing.assert_array_equal(_np(g.label[0]), _np(w.label[0]))
            assert g.pad == w.pad
    assert got[-1].pad == want[-1].pad
    assert it.provide_data == jit.provide_data


def test_resize_csv_prefetching_iters(tmp_path):
    data = np.random.rand(10, 4).astype(np.float32)
    r = mx.io.ResizeIter(mx.io.NDArrayIter(data, np.zeros(10), batch_size=5),
                         7)
    assert len(list(r)) == 7
    f = str(tmp_path / "d.csv")
    np.savetxt(f, np.random.rand(9, 4), delimiter=",")
    got = list(mx.io.CSVIter(data_csv=f, data_shape=(4,), batch_size=3))
    want = list(jmx.io.CSVIter(data_csv=f, data_shape=(4,), batch_size=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g.data[0]), _np(w.data[0]))
    base = mx.io.NDArrayIter(data[:8], np.zeros(8), batch_size=4)
    pf = mx.io.PrefetchingIter(base)
    assert len(list(pf)) == 2
    pf.reset()
    assert len(list(pf)) == 2
    pf.close()


def test_mnist_iter_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (7, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 7).astype(np.uint8)
    img_path, lbl_path = str(tmp_path / "i.gz"), str(tmp_path / "l.gz")
    with gzip.open(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 7, 28, 28) + imgs.tobytes())
    with gzip.open(lbl_path, "wb") as f:
        f.write(struct.pack(">II", 2049, 7) + labels.tobytes())
    for flat in (False, True):
        got = list(mx.io.MNISTIter(image=img_path, label=lbl_path,
                                   batch_size=3, shuffle=False, flat=flat))
        want = list(jmx.io.MNISTIter(image=img_path, label=lbl_path,
                                     batch_size=3, shuffle=False, flat=flat))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g.data[0]), _np(w.data[0]))
            np.testing.assert_array_equal(_np(g.label[0]), _np(w.label[0]))


def test_unported_iterators_raise():
    with pytest.raises(mx.MXNetError, match="A13"):
        mx.io.LibSVMIter(data_libsvm="x", data_shape=(3,))
    with pytest.raises(mx.MXNetError):
        mx.io.MXDataIter()
