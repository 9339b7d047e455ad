"""Detection augmenters and ``ImageDetIter`` (reference:
``python/mxnet/image/detection.py``). They come with the detection nets,
ROADMAP A13; every name raises until then."""

from __future__ import annotations

from ..base import MXNetError

_NAMES = ("DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
          "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
          "DetForceResizeAug", "CreateDetAugmenter", "ImageDetIter")


def _unported(name):
    def raise_a13(*args, **kwargs):
        raise MXNetError(f"mx.image.{name}: detection augmentation comes "
                         "with the detection nets (ROADMAP A13)")

    raise_a13.__name__ = name
    return raise_a13


for _name in _NAMES:
    globals()[_name] = _unported(_name)
