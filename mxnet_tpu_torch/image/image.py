"""Image IO, resize and crop, the augmenters and the legacy ``ImageIter``
(reference: ``python/mxnet/image/image.py``; the port's copy of
``mxnet_tpu/image/image.py``).

Codecs are Pillow's, as in the JAX package. Decoded images are host
arrays (``ctx=cpu``): the data path works on the host and a batch
reaches the card through ``gluon.data.DevicePrefetcher`` (or
``DataLoader(device=...)``). The resize and crop functions keep an
array's device. Resizing is the JAX package's ``jax.image.resize`` (a
separable weight matrix per resized axis, antialiased when it shrinks;
nearest neighbour by index) written in torch.
"""

from __future__ import annotations

import io as _io
import math
import os
import random as _pyrandom

import numpy as _np
import torch

from ..base import MXNetError
from ..context import cpu
from ..ndarray.ndarray import NDArray, array as _array


def _pil():
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - Pillow is a dependency
        raise MXNetError(
            "image codec requires Pillow, which is unavailable; decode "
            "images ahead of time or install Pillow") from e
    return Image


def _tensor(src):
    """The tensor behind an NDArray, or a numpy array as a host tensor."""
    if isinstance(src, NDArray):
        return src.data
    if isinstance(src, torch.Tensor):
        return src
    return torch.from_numpy(_np.ascontiguousarray(src))


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode image bytes into an HWC uint8 host NDArray (``flag=0``:
    grayscale, one channel; ``to_rgb=False``: BGR, OpenCV's order)."""
    Image = _pil()
    img = Image.open(_io.BytesIO(bytes(buf)))
    if flag == 0:
        arr = _np.asarray(img.convert("L"))[:, :, None]
    else:
        arr = _np.asarray(img.convert("RGB"))
        if not to_rgb:
            arr = arr[:, :, ::-1]
    return _array(arr.copy(), ctx=cpu(), dtype="uint8")


def imencode(img, quality=95, img_fmt=".jpg"):
    """Encode an HWC uint8 image as JPEG (``img_fmt`` containing "jp")
    or PNG bytes."""
    Image = _pil()
    if isinstance(img, NDArray):
        img = img.asnumpy()
    img = _np.asarray(img).astype("uint8")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    bio = _io.BytesIO()
    fmt = "JPEG" if "jp" in img_fmt.lower() else "PNG"
    Image.fromarray(img).save(bio, format=fmt, quality=quality)
    return bio.getvalue()


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


_INTERP = {0: "nearest", 1: "linear", 2: "cubic", 3: "linear", 4: "linear",
           9: "linear", 10: "linear"}


def _linear_kernel(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _cubic_kernel(x):
    # Keys' cubic convolution (a = -0.5), as jax.image's "cubic"
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(m, n, kernel, device):
    """``(m, n)`` float32 weights that resample an axis of ``m`` samples
    to ``n`` (jax.image's ``compute_weight_mat`` with scale ``n / m``,
    no translation, antialiased)."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample_f = (torch.arange(n, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(m, dtype=f32, device=device)[
        :, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(_np.finfo(_np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_tensor(t, shape, method="linear"):
    """``jax.image.resize(t, shape, method)`` in torch: a float result
    (float32 for an integer input) for "linear"/"cubic", the input's
    type for "nearest"."""
    if method == "nearest":
        for d, (m, n) in enumerate(zip(t.shape, shape)):
            if m != n:
                off = torch.floor((torch.arange(n, dtype=torch.float32)
                                   + 0.5) * m / n).to(torch.long)
                t = t.index_select(d, off.to(t.device))
        return t
    kernel = _linear_kernel if method == "linear" else _cubic_kernel
    if not t.is_floating_point():
        t = t.to(torch.float32)
    for d, (m, n) in enumerate(zip(t.shape, shape)):
        if m != n:
            w = _weight_mat(m, n, kernel, t.device).to(t.dtype)
            t = torch.tensordot(t, w, dims=([d], [0])).movedim(-1, d)
    return t


def imresize(src, w, h, interp=1):
    """Resize an HWC image to ``(h, w)``; a uint8 image is rounded and
    clipped back to uint8."""
    raw = _tensor(src)
    out = resize_tensor(raw.to(torch.float32), (h, w, raw.shape[2]),
                        _INTERP.get(interp, "linear"))
    if raw.dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    else:
        out = out.to(raw.dtype)
    return NDArray(out)


def imrotate(src, rotation_degrees, zoom_in=False, zoom_out=False):
    """Rotate an HWC image about its centre by nearest-neighbour lookup;
    what falls outside is 0."""
    raw = _tensor(src)
    theta = math.radians(float(rotation_degrees))
    h, w = raw.shape[0], raw.shape[1]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys, xs = torch.meshgrid(torch.arange(h, device=raw.device),
                            torch.arange(w, device=raw.device),
                            indexing="ij")
    ys, xs = ys.to(torch.float32), xs.to(torch.float32)
    yr = (ys - cy) * math.cos(theta) - (xs - cx) * math.sin(theta) + cy
    xr = (ys - cy) * math.sin(theta) + (xs - cx) * math.cos(theta) + cx
    yi = torch.clamp(torch.round(yr), 0, h - 1).to(torch.long)
    xi = torch.clamp(torch.round(xr), 0, w - 1).to(torch.long)
    valid = (yr >= 0) & (yr <= h - 1) & (xr >= 0) & (xr <= w - 1)
    out = raw[yi, xi]
    return NDArray(torch.where(valid[..., None], out, torch.zeros_like(out)))


def resize_short(src, size, interp=2):
    """Resize so that the shorter side is ``size``."""
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """The ``(x0, y0, w, h)`` window, resized to ``size`` ``(w, h)``
    when given and different."""
    out = NDArray(_tensor(src)[y0:y0 + h, x0:x0 + w])
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    h, w = src.shape[0], src.shape[1]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        new_ratio = _np.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round(_np.sqrt(target_area * new_ratio)))
        new_h = int(round(_np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def _like(v, src):
    if isinstance(v, NDArray):
        return v
    return _array(_np.asarray(v), ctx=src.context)


def color_normalize(src, mean, std=None):
    if mean is not None:
        src = src - _like(mean, src)
    if std is not None:
        src = src / _like(std, src)
    return src


# ---------------------------------------------------------------------------
# augmenters (reference: ``image.py:Augmenter`` family)
# ---------------------------------------------------------------------------


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return NDArray(torch.flip(_tensor(src), dims=(1,)))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        gray = float(src.mean().asscalar())
        return src * alpha + gray * (1 - alpha)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        coef = _array(_np.array([[[0.299, 0.587, 0.114]]], dtype="float32"),
                      ctx=src.context)
        gray = (src * coef).sum(axis=2, keepdims=True)
        return src * alpha + gray * (1 - alpha)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """The standard augmenter list (reference: ``CreateAugmenter``);
    ``mean=True``/``std=True`` take ImageNet's."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(_RandomSizedCropAug(crop_size, inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if contrast:
        auglist.append(ContrastJitterAug(contrast))
    if saturation:
        auglist.append(SaturationJitterAug(saturation))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and (std is not None or isinstance(mean, _np.ndarray)):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class _RandomSizedCropAug(Augmenter):
    def __init__(self, size, interp):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, (0.08, 1.0),
                                (3 / 4.0, 4 / 3.0), self.interp)[0]


class ImageIter:
    """The legacy Python image iterator over a ``.rec`` pack, a ``.lst``
    file or an in-memory list (reference: ``image.ImageIter``). Batches
    are NCHW host arrays; a short last batch repeats its last image and
    reports ``pad``."""

    def __init__(self, batch_size, data_shape, label_width=1, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, imglist=None, dtype="float32",
                 last_batch_handle="pad", **kwargs):
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.dtype = dtype
        self.auglist = aug_list if aug_list is not None else CreateAugmenter(
            self.data_shape, **{k: v for k, v in kwargs.items()
                                if k in ("resize", "rand_crop", "rand_resize",
                                         "rand_mirror", "mean", "std")})
        self.imgrec = None
        self.seq = None
        self.imglist = {}
        if path_imgrec:
            from ..recordio import MXIndexedRecordIO

            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            self.imgrec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
            self.seq = list(self.imgrec.keys)
        elif path_imglist:
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = _np.array([float(x) for x in parts[1:-1]],
                                      dtype="float32")
                    self.imglist[int(parts[0])] = (label, parts[-1])
            self.seq = list(self.imglist.keys())
        elif imglist is not None:
            for i, item in enumerate(imglist):
                self.imglist[i] = (_np.array(item[0], dtype="float32")
                                   if not _np.isscalar(item[0])
                                   else _np.array([item[0]], dtype="float32"),
                                   item[1])
            self.seq = list(self.imglist.keys())
        else:
            raise MXNetError("either path_imgrec, path_imglist or imglist "
                             "required")
        self.path_root = path_root
        self.provide_data = [("data", (batch_size,) + self.data_shape)]
        self.provide_label = [("label", (batch_size, label_width))]
        self.cursor = 0
        self.reset()

    def reset(self):
        if self.shuffle:
            _pyrandom.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cursor = 0

    def next_sample(self):
        if self.cursor >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cursor]
        self.cursor += 1
        if self.imgrec is not None:
            from ..recordio import unpack

            header, img = unpack(self.imgrec.read_idx(idx))
            return header.label, img
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root, fname), "rb") as f:
            return label, f.read()

    def next(self):
        from ..io import DataBatch
        from ..ndarray.ndarray import torch_dtype

        batch_data = []
        batch_label = []
        pad = 0
        try:
            while len(batch_data) < self.batch_size:
                label, s = self.next_sample()
                data = imdecode(s)
                for aug in self.auglist:
                    data = aug(data)
                batch_data.append(data.data.to(torch_dtype(self.dtype))
                                  .permute(2, 0, 1))
                batch_label.append(_np.atleast_1d(_np.asarray(label)))
        except StopIteration:
            if not batch_data:
                raise
            while len(batch_data) < self.batch_size:
                pad += 1
                batch_data.append(batch_data[-1])
                batch_label.append(batch_label[-1])
        return DataBatch(data=[NDArray(torch.stack(batch_data))],
                         label=[_array(_np.stack(batch_label), ctx=cpu())],
                         pad=pad)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self
