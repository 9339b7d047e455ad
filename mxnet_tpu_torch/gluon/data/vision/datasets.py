"""Vision datasets (reference: ``gluon/data/vision/datasets.py``; the
port's copy of ``mxnet_tpu/gluon/data/vision/datasets.py``).

Nothing is downloaded: the datasets read the standard on-disk formats
from ``root`` (MNIST idx files, CIFAR binary batches, RecordIO packs,
image folders). Images are host arrays.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as _np

from ....base import MXNetError
from ..dataset import Dataset, RecordFileDataset
from ....context import cpu
from ....ndarray.ndarray import array as _array


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from idx files (reference: ``vision.MNIST``)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte.gz", None)
        self._train_label = ("train-labels-idx1-ubyte.gz", None)
        self._test_data = ("t10k-images-idx3-ubyte.gz", None)
        self._test_label = ("t10k-labels-idx1-ubyte.gz", None)
        super().__init__(root, transform)

    def _open(self, fname):
        path = os.path.join(self._root, fname)
        if os.path.exists(path):
            return gzip.open(path, "rb")
        raw = path[:-3]
        if os.path.exists(raw):
            return open(raw, "rb")
        raise MXNetError(
            f"{path} not found, and nothing is downloaded: place the "
            "MNIST idx files under the dataset root"
        )

    def _get_data(self):
        data_file, label_file = (
            (self._train_data[0], self._train_label[0]) if self._train
            else (self._test_data[0], self._test_label[0])
        )
        with self._open(label_file) as fin:
            struct.unpack(">II", fin.read(8))
            label = _np.frombuffer(fin.read(), dtype=_np.uint8).astype(_np.int32)
        with self._open(data_file) as fin:
            _, n, rows, cols = struct.unpack(">IIII", fin.read(16))
            data = _np.frombuffer(fin.read(), dtype=_np.uint8)
            data = data.reshape(n, rows, cols, 1)
        self._data = _array(data, ctx=cpu(), dtype="uint8")
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from the python/binary batches."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = _np.frombuffer(fin.read(), dtype=_np.uint8).reshape(-1, 3073)
        return (raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                raw[:, 0].astype(_np.int32))

    def _get_data(self):
        if self._train:
            files = [f"data_batch_{i}.bin" for i in range(1, 6)]
        else:
            files = ["test_batch.bin"]
        data, label = [], []
        for f in files:
            path = os.path.join(self._root, f)
            if not os.path.exists(path):
                raise MXNetError(
                    f"{path} not found and download is unavailable. Place "
                    "the CIFAR10 binary batches under the dataset root."
                )
            d, l = self._read_batch(path)
            data.append(d)
            label.append(l)
        self._data = _array(_np.concatenate(data), ctx=cpu(), dtype="uint8")
        self._label = _np.concatenate(label)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = _np.frombuffer(fin.read(), dtype=_np.uint8).reshape(-1, 3074)
        return (raw[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                raw[:, 0 + self._fine_label].astype(_np.int32))

    def _get_data(self):
        files = ["train.bin"] if self._train else ["test.bin"]
        data, label = [], []
        for f in files:
            path = os.path.join(self._root, f)
            if not os.path.exists(path):
                raise MXNetError(f"{path} not found (download unavailable)")
            d, l = self._read_batch(path)
            data.append(d)
            label.append(l)
        self._data = _array(_np.concatenate(data), ctx=cpu(), dtype="uint8")
        self._label = _np.concatenate(label)


class ImageRecordDataset(RecordFileDataset):
    """Images + labels from a RecordIO pack (reference:
    ``ImageRecordDataset``)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....recordio import unpack
        from ....image import imdecode

        record = super().__getitem__(idx)
        header, img = unpack(record)
        img = imdecode(img, flag=self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """A folder-per-class image dataset (reference: ``ImageFolderDataset``)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".bmp"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                ext = os.path.splitext(filename)[1].lower()
                if ext in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ....image import imread

        img = imread(self.items[idx][0], flag=self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
