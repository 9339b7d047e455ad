"""``mx.gluon.model_zoo.vision`` of the port: the ResNet family
(``get_model(name)`` registry). Random weights only: pretrained files are
not shipped.
"""

from ....base import MXNetError
from .resnet import (  # noqa: F401
    BasicBlockV1,
    BasicBlockV2,
    BottleneckV1,
    BottleneckV2,
    ResNetV1,
    ResNetV2,
    get_resnet,
    resnet18_v1,
    resnet18_v2,
    resnet34_v1,
    resnet34_v2,
    resnet50_v1,
    resnet50_v2,
    resnet101_v1,
    resnet101_v2,
    resnet152_v1,
    resnet152_v2,
)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """A model of the zoo by name (``"resnet50_v1"`` ...)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(
            f"Model {name} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)
