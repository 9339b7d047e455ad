"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

It grows slice by slice beside the JAX package, which stays the
reference. It imports ``torch`` and nothing of JAX or ``mxnet_tpu``.
Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``; with no CUDA card and no explicit CPU request they
raise. Import as::

    import mxnet_tpu_torch as mx
    net = mx.serving.TransformerDecoderLM(vocab_size=64)   # on mx.gpu(0)
    eng = mx.serving.GenerationEngine(net, [8, 16], slots=4, chunk=4)
"""

__version__ = "0.1.0"

from . import base  # noqa: F401
from .base import MXNetError  # noqa: F401
from .context import cpu, gpu, resolve_device  # noqa: F401
from . import serving  # noqa: F401
