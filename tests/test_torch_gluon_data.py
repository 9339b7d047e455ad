"""Port parity: ``gluon.data`` (datasets, samplers, ``DataLoader``,
``vision``) against the JAX package, the cases of
``tests/test_gluon_data.py`` (its two text-corpus cases are
``gluon.contrib``'s, ROADMAP A13).

Batches are host arrays in the port. Every batch is held exactly
against the reference's on the same data; random draws (``RandomSampler``
shuffles with numpy's global stream in both packages, the crops with
Python's ``random``) are seeded the same on both sides. The worker-pool
tests start two processes each and wait at most 120 s for a batch.
"""

import gzip
import logging
import os
import random
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu_torch.gluon import data as gdata
from mxnet_tpu_torch.gluon.data import (
    ArrayDataset,
    BatchSampler,
    DataLoader,
    IntervalSampler,
    RandomSampler,
    SequentialSampler,
    SimpleDataset,
)
from mxnet_tpu_torch.gluon.data.vision import transforms


def _np(a):
    return np.array(a.asnumpy())


def _batches(loader):
    out = []
    for b in loader:
        b = b if isinstance(b, (list, tuple)) else [b]
        out.append([_np(x) for x in b])
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_array_dataset_and_transforms():
    X = np.arange(20).reshape(10, 2)
    Y = np.arange(10)
    ds = ArrayDataset(X, Y)
    assert len(ds) == 10
    x, y = ds[3]
    np.testing.assert_array_equal(x, [6, 7])
    assert y == 3
    assert SimpleDataset(list(range(5))).transform(lambda v: v * 2)[2] == 4
    x, y = ArrayDataset(np.arange(4), np.arange(4)).transform_first(
        lambda v: v + 100)[1]
    assert x == 101 and y == 1
    eager = SimpleDataset(list(range(5))).transform(lambda v: v + 1,
                                                    lazy=False)
    assert isinstance(eager, SimpleDataset) and eager[4] == 5
    with pytest.raises(mx.MXNetError):
        ArrayDataset(np.arange(3), np.arange(4))


def test_dataset_filter_shard_take_match_jax():
    ds, jds = SimpleDataset(list(range(10))), jdata.SimpleDataset(
        list(range(10)))
    assert list(ds.filter(lambda v: v % 2 == 0)) == \
        list(jds.filter(lambda v: v % 2 == 0))
    for i in range(3):
        assert [ds.shard(3, i)[k] for k in range(len(ds.shard(3, i)))] == \
            [jds.shard(3, i)[k] for k in range(len(jds.shard(3, i)))]
    assert len(ds.take(4)) == len(jds.take(4)) == 4
    assert len(ds.take(None)) == 10


@pytest.mark.parametrize("mode", ["keep", "discard", "rollover", "pad"])
@pytest.mark.parametrize("n,bs", [(7, 3), (2, 3), (9, 3)])
def test_batch_sampler_matches_jax(mode, n, bs):
    s = BatchSampler(SequentialSampler(n), bs, mode)
    js = jdata.BatchSampler(jdata.SequentialSampler(n), bs, mode)
    for _ in range(3):  # rollover carries over epochs
        assert list(s) == list(js)
        assert len(s) == len(js)


def test_samplers_match_jax():
    assert list(SequentialSampler(5, start=2)) == \
        list(jdata.SequentialSampler(5, start=2))
    for rollover in (True, False):
        assert list(IntervalSampler(10, 3, rollover)) == \
            list(jdata.IntervalSampler(10, 3, rollover))
    np.random.seed(3)
    r = list(RandomSampler(100))
    np.random.seed(3)
    assert r == list(jdata.RandomSampler(100))
    assert sorted(r) == list(range(100))
    with pytest.raises(ValueError):
        list(BatchSampler(SequentialSampler(7), 3, "bogus"))


def test_dataloader_single_process_matches_jax():
    X = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    Y = np.arange(10).astype(np.float32)
    for kw in (dict(last_batch="keep"), dict(last_batch="discard"),
               dict(last_batch="pad"), dict(last_batch="rollover")):
        loader = DataLoader(ArrayDataset(X, Y), batch_size=4, **kw)
        jloader = jdata.DataLoader(jdata.ArrayDataset(X, Y), batch_size=4,
                                   **kw)
        for _ in range(2):
            got = _batches(loader)
            _assert_same(got, _batches(jloader))
    b = next(iter(DataLoader(ArrayDataset(X, Y), batch_size=4)))
    assert isinstance(b[0], mx.NDArray) and b[0].context == mx.cpu()
    np.random.seed(1)
    got = _batches(DataLoader(ArrayDataset(X, Y), batch_size=3,
                              shuffle=True))
    np.random.seed(1)
    _assert_same(got, _batches(jdata.DataLoader(jdata.ArrayDataset(X, Y),
                                                batch_size=3, shuffle=True)))


def test_dataloader_ndarray_samples_and_batchify_fn():
    imgs = np.random.RandomState(2).randint(0, 255, (6, 4, 4, 1)).astype(
        np.uint8)
    ds = ArrayDataset(mx.nd.array(imgs, ctx=mx.cpu(), dtype="uint8"),
                      np.arange(6).astype(np.float32))
    jds = jdata.ArrayDataset(jmx.nd.array(imgs, dtype="uint8"),
                             np.arange(6).astype(np.float32))
    _assert_same(_batches(DataLoader(ds, batch_size=4)),
                 _batches(jdata.DataLoader(jds, batch_size=4)))

    def batchify(samples):
        return mx.nd.array(np.stack(samples), ctx=mx.cpu())

    loader = DataLoader(SimpleDataset([np.ones(2, np.float32) * i
                                       for i in range(6)]),
                        batch_size=2, batchify_fn=batchify)
    assert next(iter(loader)).shape == (2, 2)
    with pytest.raises(ValueError):
        DataLoader(ds)
    with pytest.raises(ValueError):
        DataLoader(ds, batch_size=2, shuffle=True,
                   sampler=SequentialSampler(6))


def test_dataloader_thread_pool_matches_jax():
    X = np.random.RandomState(4).rand(13, 3).astype(np.float32)
    Y = np.arange(13).astype(np.float32)
    loader = DataLoader(ArrayDataset(X, Y), batch_size=4, num_workers=3,
                        thread_pool=True)
    want = _batches(jdata.DataLoader(jdata.ArrayDataset(X, Y),
                                     batch_size=4))
    for _ in range(2):
        _assert_same(_batches(loader), want)


def test_dataloader_process_pool_matches_jax():
    """Two worker processes (forkserver): batches in order, equal to the
    reference's single-process batches, over two epochs; the pool's
    workers give their batch within the 120 s timeout."""
    X = np.random.RandomState(5).rand(12, 3).astype(np.float32)
    Y = np.arange(12).astype(np.float32)
    loader = DataLoader(ArrayDataset(X, Y), batch_size=4, num_workers=2,
                        timeout=120)
    want = _batches(jdata.DataLoader(jdata.ArrayDataset(X, Y),
                                     batch_size=4))
    try:
        for _ in range(2):
            got = _batches(loader)
            _assert_same(got, want)
        b = next(iter(loader))
        assert b[0].context == mx.cpu()
    finally:
        loader._worker_pool.terminate()


def test_pin_memory_without_a_card_warns_once(caplog, monkeypatch):
    import torch

    from mxnet_tpu_torch.gluon.data import dataloader as dl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dl, "_PIN_MEMORY_WARNED", [False])
    ds = ArrayDataset(np.zeros((4, 2), np.float32), np.zeros(4, np.float32))
    with caplog.at_level(logging.WARNING):
        for _ in range(3):
            loader = DataLoader(ds, batch_size=2, pin_memory=True)
            assert not next(iter(loader))[0].data.is_pinned()
    assert sum("pin_memory" in r.message for r in caplog.records) == 1


def test_record_file_dataset_matches_jax(tmp_path):
    from mxnet_tpu_torch import recordio

    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(5):
        w.write_idx(i, f"data{i}".encode())
    w.close()
    ds, jds = gdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(ds) == len(jds) == 5
    assert [ds[i] for i in range(5)] == [jds[i] for i in range(5)]


def _ops_equal(got, want, atol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def test_transforms_match_jax():
    from mxnet_tpu.gluon.data.vision import transforms as jt

    img = (np.random.RandomState(6).rand(30, 40, 3) * 255).astype(np.uint8)
    x = mx.nd.array(img, ctx=mx.cpu(), dtype="uint8")
    jx = jmx.nd.array(img, dtype="uint8")
    t = transforms.Compose([transforms.ToTensor(),
                            transforms.Normalize((0.5, 0.4, 0.3),
                                                 (0.2, 0.25, 0.3))])
    jc = jt.Compose([jt.ToTensor(), jt.Normalize((0.5, 0.4, 0.3),
                                                 (0.2, 0.25, 0.3))])
    out = t(x)
    assert out.shape == (3, 30, 40) and out.context == mx.cpu()
    _ops_equal(out, jc(jx), atol=1e-6)
    _ops_equal(transforms.Cast("float16")(x), jt.Cast("float16")(jx))
    for name, args in (("Resize", (16,)), ("Resize", ((20, 12), True)),
                       ("Resize", (10, True)), ("CenterCrop", (20,))):
        got = getattr(transforms, name)(*args)(x)
        want = getattr(jt, name)(*args)(jx)
        assert got.shape == want.shape
        assert np.abs(_np(got).astype(int) - _np(want).astype(int)).max() \
            <= 1
    for name, args in (("RandomResizedCrop", (14,)),
                       ("RandomCrop", (12, 2))):
        random.seed(8)
        got = getattr(transforms, name)(*args)(x)
        random.seed(8)
        want = getattr(jt, name)(*args)(jx)
        assert got.shape == want.shape
        assert np.abs(_np(got).astype(int) - _np(want).astype(int)).max() \
            <= 1
    np.testing.assert_array_equal(
        _np(transforms.RandomFlipLeftRight(1.0)(x)), img[:, ::-1])


def test_random_transforms_repeat_under_seed():
    aug = transforms.Compose([
        transforms.RandomFlipLeftRight(),
        transforms.RandomColorJitter(brightness=0.4, contrast=0.3,
                                     saturation=0.3, hue=0.1),
        transforms.RandomLighting(0.1),
    ])
    x = mx.nd.array(np.random.RandomState(0).randint(0, 255, (8, 8, 3))
                    .astype(np.float32), ctx=mx.cpu())
    mx.random.seed(11)
    a = _np(aug(x))
    mx.random.seed(11)
    b = _np(aug(x))
    np.testing.assert_array_equal(a, b)
    mx.random.seed(12)
    assert not np.allclose(a, _np(aug(x)))
    for cls, arg in ((transforms.RandomBrightness, 0.5),
                     (transforms.RandomContrast, 0.5),
                     (transforms.RandomSaturation, 0.5),
                     (transforms.RandomHue, 0.2),
                     (transforms.RandomFlipTopBottom, 0.5)):
        assert cls(arg)(x).shape == x.shape


def _write_mnist(root, n=9, prefix="train"):
    rng = np.random.RandomState(7)
    imgs = rng.randint(0, 255, (n, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    name = "train" if prefix == "train" else "t10k"
    with gzip.open(os.path.join(root, f"{name}-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with gzip.open(os.path.join(root, f"{name}-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def test_vision_datasets_from_local_files_match_jax(tmp_path):
    from mxnet_tpu.gluon.data import vision as jvision
    from mxnet_tpu_torch.gluon.data import vision

    _write_mnist(str(tmp_path))
    _write_mnist(str(tmp_path), prefix="test")
    for cls in ("MNIST", "FashionMNIST"):
        for train in (True, False):
            ds = getattr(vision, cls)(root=str(tmp_path), train=train)
            jds = getattr(jvision, cls)(root=str(tmp_path), train=train)
            assert len(ds) == len(jds) == 9
            for i in (0, 8):
                np.testing.assert_array_equal(_np(ds[i][0]),
                                              _np(jds[i][0]))
                assert ds[i][1] == jds[i][1]
    cifar = tmp_path / "cifar"
    cifar.mkdir()
    raw = np.random.RandomState(8).randint(0, 255, (4, 3073)).astype(
        np.uint8)
    raw[:, 0] = [1, 2, 3, 4]
    for i in range(1, 6):
        (cifar / f"data_batch_{i}.bin").write_bytes(raw.tobytes())
    ds = vision.CIFAR10(root=str(cifar))
    jds = jvision.CIFAR10(root=str(cifar))
    assert len(ds) == len(jds) == 20
    np.testing.assert_array_equal(_np(ds[5][0]), _np(jds[5][0]))
    assert ds[5][1] == jds[5][1]
    c100 = tmp_path / "c100"
    c100.mkdir()
    raw = np.random.RandomState(9).randint(0, 100, (3, 3074)).astype(
        np.uint8)
    (c100 / "train.bin").write_bytes(raw.tobytes())
    for fine in (False, True):
        ds = vision.CIFAR100(root=str(c100), fine_label=fine)
        jds = jvision.CIFAR100(root=str(c100), fine_label=fine)
        np.testing.assert_array_equal(_np(ds[2][0]), _np(jds[2][0]))
        assert ds[2][1] == jds[2][1]
    with pytest.raises(mx.MXNetError, match="not found"):
        vision.MNIST(root=str(tmp_path / "none"))


def test_image_datasets_match_jax(tmp_path):
    from mxnet_tpu.gluon.data import vision as jvision
    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.gluon.data import vision

    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(3):
        img = np.random.RandomState(i).randint(0, 255, (12, 10, 3)).astype(
            np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(i), i, 0),
                                         img))
        d = tmp_path / "folder" / f"class{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{i}.png").write_bytes(mx.image.imencode(img, img_fmt=".png"))
    w.close()
    ds = vision.ImageRecordDataset(rec)
    jds = jvision.ImageRecordDataset(rec)
    for i in range(3):
        np.testing.assert_array_equal(_np(ds[i][0]), _np(jds[i][0]))
        assert ds[i][1] == jds[i][1]
    tds = vision.ImageRecordDataset(rec).transform_first(
        transforms.ToTensor())
    assert tds[1][0].shape == (3, 12, 10)
    fd = vision.ImageFolderDataset(str(tmp_path / "folder"))
    jfd = jvision.ImageFolderDataset(str(tmp_path / "folder"))
    assert fd.synsets == jfd.synsets and fd.items == jfd.items
    np.testing.assert_array_equal(_np(fd[2][0]), _np(jfd[2][0]))


def test_unported_names_raise():
    with pytest.raises(mx.MXNetError, match="A13"):
        gdata.StreamReader([])
    # SuperstepRing is ported (its contract: test_torch_superstep.py)
    ring = gdata.SuperstepRing([], k=2)
    assert list(ring) == [] and ring.k == 2
