"""``mx.image`` (reference: ``python/mxnet/image/``): Pillow codecs, the
resize and crop functions, the augmenters and the legacy ``ImageIter``.
The detection names raise naming ROADMAP A13."""

from .image import (  # noqa: F401
    imdecode,
    imencode,
    imread,
    imresize,
    imrotate,
    resize_short,
    fixed_crop,
    center_crop,
    random_crop,
    random_size_crop,
    color_normalize,
    CreateAugmenter,
    Augmenter,
    ResizeAug,
    ForceResizeAug,
    RandomCropAug,
    CenterCropAug,
    HorizontalFlipAug,
    CastAug,
    ColorNormalizeAug,
    BrightnessJitterAug,
    ContrastJitterAug,
    SaturationJitterAug,
    ImageIter,
)
from .detection import (  # noqa: F401
    DetAugmenter,
    DetBorrowAug,
    DetRandomSelectAug,
    DetHorizontalFlipAug,
    DetRandomCropAug,
    DetRandomPadAug,
    DetForceResizeAug,
    CreateDetAugmenter,
    ImageDetIter,
)
