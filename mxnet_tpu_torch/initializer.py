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
import re

import numpy as _np
import torch

from .base import MXNetError

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


class InitDesc(str):
    """A parameter's name with its attributes (reference: ``InitDesc``):
    an ``__init__`` attribute names the initializer that fills it."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


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
        """Initialise ``arr`` (an NDArray) for the parameter ``name`` (a
        string or an :class:`InitDesc`)."""
        if not isinstance(name, str):
            raise TypeError("desc must be a string or InitDesc")
        init = getattr(name, "attrs", {}).get("__init__", "")
        if init:
            create(init)._init_weight(name, arr)
            return
        suffix = name.lower()
        if suffix.endswith("moving_inv_var") or suffix.endswith("moving_avg"):
            self._init_zero(name, arr)
        elif suffix.endswith("bias") or suffix.endswith("beta"):
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

    def _set(self, arr, value):
        """Write host values (numpy) into ``arr`` in its type."""
        t = arr.data
        with torch.no_grad():
            t.copy_(torch.as_tensor(_np.asarray(value)).to(t.dtype))

    def _init_weight(self, desc, arr):
        raise NotImplementedError


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._init_zero(_, arr)


zeros = Zero


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._init_one(_, arr)


ones = One


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


@register
class Orthogonal(Initializer):
    """An orthogonal matrix times ``scale``, from the singular vectors of
    a uniform (``rand_type="uniform"``) or normal draw (reference:
    ``Orthogonal``)."""

    def __init__(self, scale=1.414, rand_type="uniform", seed=None):
        super().__init__(seed=seed)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        t = arr.data
        nout = t.shape[0]
        nin = int(math.prod(t.shape[1:]))
        gen = self._generator(t.device)
        if self.rand_type == "uniform":
            tmp = torch.rand((nout, nin), device=t.device, generator=gen,
                             dtype=torch.float64) * 2.0 - 1.0
        else:
            tmp = torch.randn((nout, nin), device=t.device, generator=gen,
                              dtype=torch.float64)
        u, _s, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        with torch.no_grad():
            t.copy_((self.scale * q).reshape(t.shape).to(t.dtype))


@register
class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU nets: Gaussian Xavier with
    magnitude ``2 / (1 + slope^2)`` (reference: ``MSRAPrelu``)."""

    def __init__(self, factor_type="avg", slope=0.25, seed=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         seed=seed)


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a deconvolution's weight
    (reference: ``Bilinear``)."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        weight = _np.zeros(shape, dtype="float32")
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(_np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        self._set(arr, weight)


@register
class LSTMBias(Initializer):
    """Zeros but the forget gate's quarter, ``forget_bias`` (reference:
    ``LSTMBias``)."""

    def __init__(self, forget_bias=1.0):
        super().__init__()
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        b = _np.zeros(arr.shape)
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)


class Mixed:
    """The first initializer whose pattern matches the parameter's name
    (reference: ``initializer.py:Mixed``)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must have same length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(f"Parameter name {name} did not match any pattern")


class Load:
    """Values from a loaded ``{name: NDArray}`` dict (``arg:``/``aux:``
    prefixes dropped), else ``default_init`` (reference: ``Load``)."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {
            k.replace("arg:", "").replace("aux:", ""): v
            for k, v in param.items()}
        self.default_init = default_init

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            src = src.data if hasattr(src, "data") and isinstance(
                src.data, torch.Tensor) else torch.as_tensor(_np.asarray(src))
            with torch.no_grad():
                arr.data.copy_(src.to(arr.data.device, arr.data.dtype))
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise ValueError(f"Cannot init parameter {name} from loaded params")


_ALIASES = {"zeros": "zero", "ones": "one", "gaussian": "normal",
            "msraprelu": "msraprelu", "xavier": "xavier"}


def create(name, **kwargs):
    """An initializer from an instance or a registered name (``"zeros"``,
    ``"ones"``, ``"gaussian"``/``"normal"``, ``"uniform"``, ``"xavier"``,
    ``"msraprelu"``, ``"orthogonal"``, ``"bilinear"``, ``"lstmbias"``,
    ...)."""
    if isinstance(name, Initializer):
        return name
    if name is None or name == "":
        return Uniform()
    key = _ALIASES.get(name.lower(), name.lower())
    if key not in _REGISTRY:
        raise MXNetError(f"unknown initializer {name}")
    return _REGISTRY[key](**kwargs)


registry = _REGISTRY
