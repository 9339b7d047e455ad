"""``mx.nd.random``: the sampling API of :mod:`mxnet_tpu_torch.random`
(PyTorch counterpart of ``mxnet_tpu/ndarray/random.py``)."""

from ..random import (  # noqa: F401
    bernoulli,
    exponential,
    gamma,
    multinomial,
    normal,
    poisson,
    randint,
    randn,
    seed,
    shuffle,
    uniform,
)
