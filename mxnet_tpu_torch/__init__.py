"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

It grows slice by slice beside the JAX package, which stays the
reference. It imports ``torch`` and nothing of JAX or ``mxnet_tpu``.
Entry points run on ``cuda:0`` unless the caller asks for the CPU
(``ctx=mx.cpu()`` / ``device="cpu"``); with no CUDA card and no explicit
CPU request they raise. (MXNet's own default context was the CPU.)
Import as::

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    mx.random.seed(0)                 # dropout, samplers, CUDA-graph replays
    net = mx.models.bert_base()       # dropout 0.1, pooler, NSP and MLM heads
    net.initialize(init=mx.initializer.Normal(0.02))      # on mx.gpu(0)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-4, "wd": 0.01})
    sce = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = sce(net(x)[-1], y)
    loss.backward()
    trainer.step(batch_size)
    mx.engine.waitall()                     # or loss.wait_to_read()

    net = mx.models.llama3_8b(num_layers=2)                # one-step harness
    net.initialize(init=mx.initializer.Normal(0.02))
    step = mx.parallel.SPMDTrainStep(net, lm_loss, "adam", {}, mesh=None)
    loss = step.run_steps(x, y, 10, lr=1e-4)

    net = mx.serving.TransformerDecoderLM(vocab_size=64)   # serving
    eng = mx.serving.GenerationEngine(net, [8, 16], slots=4, chunk=4)
"""

__version__ = "0.2.0"

from . import base  # noqa: F401
from .base import MXNetError  # noqa: F401
from .context import (  # noqa: F401
    Context,
    cpu,
    cpu_pinned,
    current_context,
    gpu,
    num_gpus,
    num_tpus,
    resolve_device,
    tpu,
)
from . import engine  # noqa: F401
from . import random  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from .ndarray import NDArray  # noqa: F401
from . import autograd  # noqa: F401
from . import initializer  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import amp  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from . import fusedstep  # noqa: F401
from . import observability  # noqa: F401
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import metric  # noqa: F401
from . import callback  # noqa: F401
from . import gluon  # noqa: F401
from . import recordio  # noqa: F401
from . import image  # noqa: F401
from . import io  # noqa: F401
from . import models  # noqa: F401
from . import parallel  # noqa: F401
from . import contrib  # noqa: F401
from . import resilience  # noqa: F401
from . import serving  # noqa: F401
from . import test_utils  # noqa: F401
from . import runtime  # noqa: F401
from . import util  # noqa: F401
from . import name  # noqa: F401
from . import attribute  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from .util import is_np_array, reset_np, set_np  # noqa: F401
