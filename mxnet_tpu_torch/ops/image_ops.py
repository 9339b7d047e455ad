"""The ``mx.nd.image`` operator family (reference:
``src/operator/image/image_random.cc``, ``resize.cc``, ``crop.cc``; the
port's copy of ``mxnet_tpu/ops/image_ops.py``), under the JAX package's
registry names and their ``_image_*`` aliases.

Images are HWC (batched: NHWC), uint8 in [0, 255] or float. Resizing is
``image.resize_tensor`` (the JAX package's ``jax.image.resize`` in
torch). The ``random_*`` ops draw their factors, host scalars, from the
host's ``mx.random`` stream, so augmentation repeats under
``mx.random.seed``; the numbers are torch's, not ``jax.random``'s.
"""

from __future__ import annotations

import numpy as _np
import torch

from .. import random as _random
from .registry import register

_HOST = torch.device("cpu")


def _hwc_axes(x):
    """(h_axis, w_axis, c_axis) for HWC or NHWC input."""
    if x.ndim == 3:
        return 0, 1, 2
    if x.ndim == 4:
        return 1, 2, 3
    raise ValueError(f"image op expects HWC or NHWC, got shape "
                     f"{tuple(x.shape)}")


def _f32(x):
    return x.to(torch.float32)


@register("to_tensor", aliases=("_image_to_tensor",))
def to_tensor(data):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (batched: NHWC -> NCHW).
    Scaled by the float32 reciprocal of 255, as the JAX package's
    compiled division by the constant is."""
    x = _f32(data) * (1.0 / 255.0)
    if data.ndim == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register("image_normalize", aliases=("_image_normalize",))
def image_normalize(data, mean=(0.0,), std=(1.0,)):
    """Per-channel (x - mean)/std on CHW (or NCHW) float input."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=data.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=data.device)
    shape = (-1, 1, 1) if data.ndim == 3 else (1, -1, 1, 1)
    return (data - mean.reshape(shape)) / std.reshape(shape)


@register("image_resize", aliases=("_image_resize",))
def image_resize(data, size=None, keep_ratio=False, interp=1):
    """Bilinear (interp=1) or nearest (interp=0) HWC resize; ``size`` is
    (w, h) or a single int, reference semantics. An integer image comes
    back in its type, truncated."""
    from ..image.image import resize_tensor

    h_ax, w_ax, _ = _hwc_axes(data)
    h, w = data.shape[h_ax], data.shape[w_ax]
    if isinstance(size, int):
        if keep_ratio:
            if h > w:
                new_w, new_h = size, int(h * size / w)
            else:
                new_w, new_h = int(w * size / h), size
        else:
            new_w = new_h = size
    else:
        new_w, new_h = size
    shape = list(data.shape)
    shape[h_ax], shape[w_ax] = new_h, new_w
    out = resize_tensor(_f32(data), tuple(shape),
                        "nearest" if interp == 0 else "linear")
    return out.to(data.dtype) if not data.is_floating_point() else out


@register("image_crop", aliases=("_image_crop",))
def image_crop(data, x=0, y=0, width=0, height=0):
    """Crop the (x, y, width, height) window out of an HWC/NHWC image."""
    if data.ndim == 3:
        return data[y:y + height, x:x + width, :]
    return data[:, y:y + height, x:x + width, :]


@register("flip_left_right", aliases=("_image_flip_left_right",))
def flip_left_right(data):
    return torch.flip(data, dims=(_hwc_axes(data)[1],))


@register("flip_top_bottom", aliases=("_image_flip_top_bottom",))
def flip_top_bottom(data):
    return torch.flip(data, dims=(_hwc_axes(data)[0],))


def _uniform():
    return float(torch.rand((), generator=_random.generator(_HOST)))


def _coin(p):
    return _uniform() < p


@register("random_flip_left_right",
          aliases=("_image_random_flip_left_right",))
def random_flip_left_right(data, p=0.5):
    return flip_left_right(data) if _coin(p) else data


@register("random_flip_top_bottom",
          aliases=("_image_random_flip_top_bottom",))
def random_flip_top_bottom(data, p=0.5):
    return flip_top_bottom(data) if _coin(p) else data


def _uniform_factor(lo, hi):
    return lo + (hi - lo) * _uniform()


def _blend(a, b, f):
    return _f32(a) * f + b * (1.0 - f)


def _gray(x, c_ax):
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                     device=x.device)
    shape = [1] * x.ndim
    shape[c_ax] = 3
    return torch.sum(_f32(x) * w.reshape(shape), dim=c_ax, keepdim=True)


@register("random_brightness", aliases=("_image_random_brightness",))
def random_brightness(data, min_factor=1.0, max_factor=1.0):
    """Scale by f ~ U[min_factor, max_factor]; f=1 is the identity
    (gluon's ``RandomBrightness(b)`` passes ``(max(0, 1-b), 1+b)``)."""
    f = _uniform_factor(min_factor, max_factor)
    return _f32(data) * f


def _img_mean(x, c_ax):
    """Per-IMAGE gray mean: reduce H, W, C but keep the batch axis."""
    g = _gray(x, c_ax)
    if x.ndim == 4:
        return g.mean(dim=(1, 2, 3), keepdim=True)
    return g.mean()


@register("random_contrast", aliases=("_image_random_contrast",))
def random_contrast(data, min_factor=1.0, max_factor=1.0):
    """Blend toward each image's own gray mean with f ~ U[min, max]."""
    c_ax = _hwc_axes(data)[2]
    f = _uniform_factor(min_factor, max_factor)
    return _blend(data, _img_mean(data, c_ax), f)


@register("random_saturation", aliases=("_image_random_saturation",))
def random_saturation(data, min_factor=1.0, max_factor=1.0):
    c_ax = _hwc_axes(data)[2]
    f = _uniform_factor(min_factor, max_factor)
    return _blend(data, _gray(data, c_ax), f)


def _hue_matrix(f):
    """The YIQ chroma-plane rotation by ``(f - 1) * pi`` in RGB (float32,
    computed in numpy as the JAX package does)."""
    alpha = (f - 1.0) * 3.141592653589793
    u, w = _np.cos(alpha), _np.sin(alpha)
    t_yiq = _np.array([[0.299, 0.587, 0.114],
                       [0.596, -0.274, -0.321],
                       [0.211, -0.523, 0.311]], _np.float32)
    t_rgb = _np.linalg.inv(t_yiq)
    rot = _np.array([[1, 0, 0], [0, u, -w], [0, w, u]], _np.float32)
    return t_rgb @ rot @ t_yiq


@register("random_hue", aliases=("_image_random_hue",))
def random_hue(data, min_factor=1.0, max_factor=1.0):
    """Hue rotation in the YIQ chroma plane; f ~ U[min, max], f=1 is the
    identity and the angle is (f-1)*pi."""
    x = _f32(data)
    c_ax = _hwc_axes(x)[2]
    m = torch.from_numpy(
        _hue_matrix(_uniform_factor(min_factor, max_factor))).to(x.device)
    return torch.movedim(torch.movedim(x, c_ax, -1) @ m.T, -1, c_ax)


@register("random_color_jitter", aliases=("_image_random_color_jitter",))
def random_color_jitter(data, brightness=0.0, contrast=0.0, saturation=0.0,
                        hue=0.0):
    """Brightness, contrast, saturation and hue jitter in a random
    order."""
    steps = []
    if brightness:
        steps.append(lambda im: random_brightness(
            im, max(0.0, 1 - brightness), 1 + brightness))
    if contrast:
        steps.append(lambda im: random_contrast(
            im, max(0.0, 1 - contrast), 1 + contrast))
    if saturation:
        steps.append(lambda im: random_saturation(
            im, max(0.0, 1 - saturation), 1 + saturation))
    if hue:
        steps.append(lambda im: random_hue(im, max(0.0, 1 - hue), 1 + hue))
    order = torch.randperm(len(steps), generator=_random.generator(_HOST)) \
        if steps else []
    x = data
    for i in [int(i) for i in order]:
        x = steps[i](x)
    return x


_EIGVAL = _np.array([55.46, 4.794, 1.148], _np.float32)
_EIGVEC = _np.array([[-0.5675, 0.7192, 0.4009],
                     [-0.5808, -0.0045, -0.8140],
                     [-0.5836, -0.6948, 0.4203]], _np.float32)


@register("adjust_lighting", aliases=("_image_adjust_lighting",))
def adjust_lighting(data, alpha=(0.0, 0.0, 0.0)):
    """AlexNet-style PCA lighting with the reference's fixed ImageNet
    eigenvectors and eigenvalues."""
    delta = torch.from_numpy(
        _EIGVEC @ (_np.asarray(alpha, _np.float32) * _EIGVAL))
    x = _f32(data)
    shape = [1] * x.ndim
    shape[_hwc_axes(x)[2]] = 3
    return x + delta.to(x.device).reshape(shape)


@register("random_lighting", aliases=("_image_random_lighting",))
def random_lighting(data, alpha_std=0.05):
    a = torch.randn(3, generator=_random.generator(_HOST)) * alpha_std
    return adjust_lighting(data, tuple(float(v) for v in a))
