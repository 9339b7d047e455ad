"""``mx.gluon.model_zoo.vision`` of the port: every classification family
of the JAX package's zoo (ResNet v1/v2, AlexNet, VGG, SqueezeNet,
DenseNet, MobileNet v1/v2, Inception-v3) behind ``get_model(name)``.
Random weights only: pretrained files are not shipped. The detection
nets (``ssd_tiny``, ``ssd_300``, ``faster_rcnn_tiny``, ``yolo3_tiny``)
are not ported yet (ROADMAP A13): their names raise ``MXNetError``.
"""

from ....base import MXNetError
from .alexnet import AlexNet, alexnet  # noqa: F401
from .densenet import (  # noqa: F401
    DenseNet,
    densenet121,
    densenet161,
    densenet169,
    densenet201,
    get_densenet,
)
from .inception import Inception3, inception_v3  # noqa: F401
from .mobilenet import (  # noqa: F401
    MobileNet,
    MobileNetV2,
    get_mobilenet,
    get_mobilenet_v2,
    mobilenet0_25,
    mobilenet0_5,
    mobilenet0_75,
    mobilenet1_0,
    mobilenet_v2_0_25,
    mobilenet_v2_0_5,
    mobilenet_v2_0_75,
    mobilenet_v2_1_0,
)
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
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .vgg import (  # noqa: F401
    VGG,
    get_vgg,
    vgg11,
    vgg11_bn,
    vgg13,
    vgg13_bn,
    vgg16,
    vgg16_bn,
    vgg19,
    vgg19_bn,
)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
    "alexnet": alexnet,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn,
    "vgg16_bn": vgg16_bn, "vgg19_bn": vgg19_bn,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
    "inceptionv3": inception_v3,
}

# the JAX package's detection nets, not ported yet
_DETECTION = ("ssd_tiny", "ssd_300", "faster_rcnn_tiny", "yolo3_tiny")


def register_model(name, fn):
    """Add ``fn(**kwargs)`` to the registry under ``name``."""
    _models[name] = fn


def get_model(name, **kwargs):
    """A model of the zoo by name (``"resnet50_v1"``, ``"mobilenetv2_1.0"``
    ...), built with ``kwargs`` (``classes=``, ``pretrained=`` ...)."""
    name = name.lower()
    if name in _DETECTION and name not in _models:
        raise MXNetError(
            f"Model {name} is a detection net of the JAX package's zoo, not "
            "ported yet (ROADMAP A13)")
    if name not in _models:
        raise MXNetError(
            f"Model {name} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)
