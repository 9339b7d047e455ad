"""Gluon Trainer: applies an optimizer to a set of parameters.

PyTorch counterpart of the per-parameter path of
``mxnet_tpu/gluon/trainer.py``: ``step(batch_size)`` sets
``rescale_grad = scale / batch_size``, reduces gradients across devices
(the identity on one device: no kvstore is made) and runs the
optimizer's update on every parameter whose ``grad_req`` is not
``"null"``. Parameters are ordered by name, as in the JAX package, so an
optimizer's per-index state lines up with it. The JAX package's fused
multi-tensor update is not ported yet.
"""

from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[k] for k in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise MXNetError(
                "params must be a list/dict/ParameterDict of Parameter")
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p}")
        self._params = list(params)
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be empty if "
                                 "optimizer is an instance")
            self._optimizer = optimizer
            optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        self._states = {}

    def step(self, batch_size, ignore_stale_grad=False):
        """Scale gradients by ``1 / batch_size``, reduce them across
        devices and update every parameter."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Sum gradients across the devices a parameter lives on; one
        device (the slice's case) has nothing to reduce."""
        for p in self._params:
            if p.grad_req == "null" or p._data is None or len(p._data) < 2:
                continue
            raise MXNetError(f"{p.name} lives on {len(p._data)} devices; "
                             "multi-device training is not ported yet")

    def update(self, batch_size, ignore_stale_grad=False):
        del ignore_stale_grad
        self._optimizer.rescale_grad = self._scale / batch_size
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or p._data is None:
                continue
            weight, grad = p.list_data()[0], p.list_grad()[0]
            if i not in self._states:
                self._states[i] = self._optimizer.create_state(i, weight)
            self._optimizer.update(i, weight, grad, self._states[i])
