"""Optimizers: the per-parameter update rules of the Gluon Trainer.

PyTorch counterpart of the base, ``SGD`` and ``Adam`` of
``mxnet_tpu/optimizer/optimizer.py``, with the same arithmetic: the
gradient is scaled by ``rescale_grad`` and clipped to ``clip_gradient``
first; SGD adds ``wd * weight`` after that; Adam adds the weight decay to
the gradient too (coupled, not AdamW's decoupled form) and folds its bias
correction into the learning rate. Updates are written in place into the
weight and state tensors (the JAX package rebinds immutable buffers).
"""

from __future__ import annotations

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


class Optimizer:
    """Base optimizer: learning rate and weight decay with the
    parameters' ``lr_mult``/``wd_mult``, gradient rescaling and clipping,
    and per-index update counts (reference: ``Optimizer``)."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, param_dict=None, **kwargs):
        if kwargs:
            raise MXNetError(f"unknown optimizer arguments {sorted(kwargs)}")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count = {}
        # index -> Parameter, for its lr_mult and wd_mult (set by Trainer)
        self.param_dict = param_dict or {}

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in _REGISTRY:
            raise MXNetError(f"unknown optimizer {name}")
        return _REGISTRY[name.lower()](**kwargs)

    def _update_count(self, index):
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _get_lr(self, index):
        p = self.param_dict.get(index)
        return self.lr * (p.lr_mult if p is not None else 1.0)

    def _get_wd(self, index):
        p = self.param_dict.get(index)
        return self.wd * (p.wd_mult if p is not None else 1.0)

    def create_state(self, index, weight):
        return None

    def _preprocess(self, grad):
        g = grad.data * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def update(self, index, weight, grad, state):
        raise NotImplementedError


create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum * mom - lr * (g + wd * w);
    w += mom`` (reference kernels ``sgd_update`` / ``sgd_mom_update``)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return NDArray(torch.zeros_like(weight.data.detach()))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight.data
        step = self._preprocess(grad) + wd * w
        if state is None:
            w.sub_(lr * step)
        else:
            mom = state.data
            mom.mul_(self.momentum).sub_(lr * step)
            w.add_(mom)


@register
class Adam(Optimizer):
    """Adam (reference kernel ``adam_update``): weight decay added to the
    gradient, bias correction folded into ``lr``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        z = weight.data.detach()
        return (NDArray(torch.zeros_like(z)), NDArray(torch.zeros_like(z)))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr_t = lr * (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        w = weight.data
        g = self._preprocess(grad) + wd * w
        m, v = state[0].data, state[1].data
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        w.sub_(lr_t * m / (torch.sqrt(v) + self.epsilon))
