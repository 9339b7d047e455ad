"""Vision transforms (reference: ``gluon/data/vision/transforms.py``; the
port's copy of ``mxnet_tpu/gluon/data/vision/transforms.py``).

Transforms take HWC uint8/float NDArrays (the data path's host arrays)
and keep their device. The random photometric transforms delegate to the
``nd.image`` operators (``ops/image_ops.py``), whose factors come from
the ``mx.random`` stream; the random crops draw from Python's ``random``,
as in the reference.
"""

from __future__ import annotations

import numpy as _np

from ....ndarray.ndarray import array as _array
from ...block import Block, HybridBlock
from ...nn.basic_layers import HybridSequential


class Compose(HybridSequential):
    """Sequentially compose transforms (reference: ``transforms.Compose``)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference: ``ToTensor``)."""

    def hybrid_forward(self, F, x):
        if x.ndim == 3:
            out = F.transpose(x, axes=(2, 0, 1))
        else:
            out = F.transpose(x, axes=(0, 3, 1, 2))
        return F.cast(out, dtype="float32") / 255.0


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def hybrid_forward(self, F, x):
        mean = _np.asarray(self._mean, dtype="float32")
        std = _np.asarray(self._std, dtype="float32")
        if mean.ndim == 1:
            shape = (-1,) + (1,) * (x.ndim - 1 - (0 if x.ndim == 3 else 1))
            mean = mean.reshape(shape if x.ndim == 3 else (1,) + shape[0:])
            std = std.reshape(mean.shape)
        return (x - _array(mean, ctx=x.ctx)) / _array(std, ctx=x.ctx)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        from ....image import imresize

        if isinstance(self._size, int):
            if self._keep:
                h, w = x.shape[0], x.shape[1]
                if w < h:
                    nw, nh = self._size, int(h * self._size / w)
                else:
                    nw, nh = int(w * self._size / h), self._size
            else:
                nw = nh = self._size
        else:
            nw, nh = self._size
        return imresize(x, nw, nh, interp=self._interpolation)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interpolation = interpolation

    def forward(self, x):
        from ....image import center_crop

        return center_crop(x, self._size, self._interpolation)[0]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        from ....image import random_size_crop

        return random_size_crop(x, self._size, self._scale, self._ratio,
                                self._interpolation)[0]


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad
        self._interpolation = interpolation

    def forward(self, x):
        from ....image import random_crop

        if self._pad:
            arr = x.asnumpy()
            p = self._pad
            arr = _np.pad(arr, ((p, p), (p, p), (0, 0)))
            x = _array(arr, ctx=x.ctx, dtype=str(x.dtype))
        return random_crop(x, self._size, self._interpolation)[0]


class RandomFlipLeftRight(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        from ....ndarray import image as _img

        return _img.random_flip_left_right(x, p=self._p)


class RandomFlipTopBottom(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        from ....ndarray import image as _img

        return _img.random_flip_top_bottom(x, p=self._p)


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._args = (max(0.0, 1 - brightness), 1 + brightness)

    def forward(self, x):
        from ....ndarray import image as _img

        return _img.random_brightness(x, *self._args)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._args = (max(0.0, 1 - contrast), 1 + contrast)

    def forward(self, x):
        from ....ndarray import image as _img

        return _img.random_contrast(x, *self._args)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._args = (max(0.0, 1 - saturation), 1 + saturation)

    def forward(self, x):
        from ....ndarray import image as _img

        return _img.random_saturation(x, *self._args)


class RandomHue(Block):
    def __init__(self, hue):
        super().__init__()
        self._args = (max(0.0, 1 - hue), 1 + hue)

    def forward(self, x):
        from ....ndarray import image as _img

        return _img.random_hue(x, *self._args)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._kwargs = dict(brightness=brightness, contrast=contrast,
                            saturation=saturation, hue=hue)

    def forward(self, x):
        from ....ndarray import image as _img

        return _img.random_color_jitter(x, **self._kwargs)


class RandomLighting(Block):
    """AlexNet-style PCA noise (reference: ``RandomLighting``)."""

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        from ....ndarray import image as _img

        return _img.random_lighting(x, alpha_std=self._alpha)
