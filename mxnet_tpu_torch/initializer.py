"""Weight initializers.

PyTorch counterpart of ``mxnet_tpu/initializer.py``: the same registry and
name-suffix dispatch (``*weight`` -> ``_init_weight``, ``*bias`` and
``*beta`` -> zeros, ``*gamma`` -> ones, BatchNorm's ``*running_mean`` /
``*moving_mean`` -> zeros and ``*running_var`` / ``*moving_var`` ->
ones). Random draws happen on the array's own device, from a
``torch.Generator`` seeded with ``seed`` when one is given, else from the
device's default generator (``torch.manual_seed``). They are not the JAX
package's numbers: parity tests carry the weights across instead.
"""

from __future__ import annotations

import math

import torch

from .base import MXNetError

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


class Initializer:
    def __init__(self, seed=None):
        self._seed = seed
        self._generators = {}

    def _generator(self, device):
        if self._seed is None:
            return None
        gen = self._generators.get(device)
        if gen is None:
            gen = self._generators[device] = \
                torch.Generator(device=device).manual_seed(self._seed)
        return gen

    def __call__(self, name, arr):
        """Initialise ``arr`` (an NDArray) for the parameter ``name``."""
        suffix = name.lower()
        if suffix.endswith("bias") or suffix.endswith("beta"):
            self._init_zero(name, arr)
        elif suffix.endswith("gamma"):
            self._init_one(name, arr)
        elif suffix.endswith("running_mean") or suffix.endswith("moving_mean"):
            self._init_zero(name, arr)
        elif suffix.endswith("running_var") or suffix.endswith("moving_var"):
            self._init_one(name, arr)
        else:
            self._init_weight(name, arr)

    def _fill(self, arr, value):
        with torch.no_grad():
            arr.data.fill_(value)

    def _init_zero(self, _, arr):
        self._fill(arr, 0.0)

    def _init_one(self, _, arr):
        self._fill(arr, 1.0)

    def _normal(self, arr, sigma):
        t = arr.data
        with torch.no_grad():
            t.copy_(torch.normal(0.0, sigma, t.shape, device=t.device,
                                 generator=self._generator(t.device)))

    def _uniform(self, arr, scale):
        t = arr.data
        with torch.no_grad():
            u = torch.rand(t.shape, device=t.device,
                           generator=self._generator(t.device))
            t.copy_(u * (2 * scale) - scale)

    def _init_weight(self, desc, arr):
        raise NotImplementedError


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._init_zero(_, arr)


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._init_one(_, arr)


@register
class Constant(Initializer):
    """Every weight set to ``value`` (PReLU's slopes start at 0.25)."""

    def __init__(self, value=0.0):
        super().__init__()
        self.value = value

    def _init_weight(self, _, arr):
        self._fill(arr, self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07, seed=None):
        super().__init__(seed=seed)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._uniform(arr, self.scale)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01, seed=None):
        super().__init__(seed=seed)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._normal(arr, self.sigma)


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 seed=None):
        super().__init__(seed=seed)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError(
                f"Xavier initializer needs >=2D weight, got {shape} for "
                f"{desc}")
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._uniform(arr, scale)
        else:
            self._normal(arr, scale)


_ALIASES = {"zeros": "zero", "ones": "one", "gaussian": "normal"}


def create(name, **kwargs):
    """An initializer from an instance or a registered name (``"zeros"``,
    ``"ones"``, ``"normal"``, ``"uniform"``, ``"xavier"``)."""
    if isinstance(name, Initializer):
        return name
    if name is None or name == "":
        return Uniform()
    key = _ALIASES.get(name.lower(), name.lower())
    if key not in _REGISTRY:
        raise MXNetError(f"unknown initializer {name}")
    return _REGISTRY[key](**kwargs)
