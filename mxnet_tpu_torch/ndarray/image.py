"""``mx.nd.image`` (reference: ``python/mxnet/ndarray/image.py``): the
friendly names of the ``ops/image_ops.py`` family."""

from __future__ import annotations

from ..ops import image_ops as _image_ops  # noqa: F401  (registers the ops)
from . import op as _op

# friendly name -> registry name (the registry names keep the flat nd
# namespace's `crop`/`normalize` free)
_NAME_MAP = {
    "to_tensor": "to_tensor",
    "normalize": "image_normalize",
    "resize": "image_resize",
    "crop": "image_crop",
    "flip_left_right": "flip_left_right",
    "flip_top_bottom": "flip_top_bottom",
    "random_flip_left_right": "random_flip_left_right",
    "random_flip_top_bottom": "random_flip_top_bottom",
    "random_brightness": "random_brightness",
    "random_contrast": "random_contrast",
    "random_saturation": "random_saturation",
    "random_hue": "random_hue",
    "random_color_jitter": "random_color_jitter",
    "adjust_lighting": "adjust_lighting",
    "random_lighting": "random_lighting",
}

for _friendly, _reg in _NAME_MAP.items():
    globals()[_friendly] = getattr(_op, _reg)

__all__ = list(_NAME_MAP)
