"""Basic Gluon layers.

PyTorch counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``, with the
same parameter names (``weight``/``bias``, ``gamma``/``beta``,
``running_mean``/``running_var``) so weights carry across name for name.
"""

from __future__ import annotations

from ..block import Block, HybridBlock
from .tpu_fusion import PendingApply, StatsArray, fused_batch_norm


class Sequential(Block):
    """Stack of blocks run in order (reference: ``nn.Sequential``)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x, *args)
            args = []
            if isinstance(x, (tuple, list)):
                args = x[1:]
                x = x[0]
        if args:
            return (x,) + tuple(args)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock):
    """Stack of hybrid blocks run in order (reference:
    ``nn.HybridSequential``)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x, *args):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer, weight ``(units, in_units)``; ``in_units=0``
    is inferred at the first call. ``flatten`` folds all but the first
    input axis into the features; otherwise the product is over the last
    axis."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), dtype=dtype, init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def infer_shape(self, x):
        in_units = 1
        for d in (x.shape[1:] if self._flatten else x.shape[-1:]):
            in_units *= d
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        if getattr(self, "_tpu_nchw", False) and x.ndim == 4:
            # NHWC interior of an optimize_for'd net: restore NCHW feature
            # order so the implicit flatten (or last-axis contraction)
            # matches NCHW-trained weights (as Flatten does)
            x = F.transpose(x, axes=(0, 3, 1, 2))
        out = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        shape = self.weight.shape
        return (f"Dense({shape[1] if shape and len(shape) > 1 else None} -> "
                f"{shape[0] if shape else None}, "
                f"{'linear' if self.act is None else self.act._act_type})")


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        if self._act_type == "relu":
            # a deferred BatchNorm output takes the relu into its pending
            # apply, so a following fused conv runs it in its prologue
            if isinstance(x, PendingApply) and not x.relu_flag:
                return x.with_relu()
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


class Dropout(HybridBlock):
    """Dropout in training mode only; rate 0 is the identity."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F.identity(x)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalisation over ``axis`` with running statistics
    (``running_mean``, ``running_var``) updated in training mode. Note the
    reference default ``scale=True`` means ``fix_gamma=False`` for the
    operator."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {
            "axis": axis, "eps": epsilon, "momentum": momentum,
            "fix_gamma": not scale, "use_global_stats": use_global_stats,
        }
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True)

    def _effective_axis(self, x):
        """In an optimize_for'd net, 4-D inputs are NHWC and normalise the
        last axis; 2-D (post-Dense) inputs keep the configured axis."""
        if getattr(self, "_tpu_nhwc", False) and x.ndim == 4:
            return 3
        return self._axis

    def infer_shape(self, x):
        c = x.shape[self._effective_axis(x)]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        k = self._kwargs
        if isinstance(x, StatsArray):
            return fused_batch_norm(
                x, gamma, beta, running_mean, running_var, k["eps"],
                k["momentum"], k["fix_gamma"], k["use_global_stats"])
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **dict(k, axis=self._effective_axis(x)))

    def __repr__(self):
        in_channels = self.gamma.shape[0] if self.gamma.shape else None
        return f"BatchNorm(axis={self._axis}, in_channels={in_channels})"


class SyncBatchNorm(BatchNorm):
    """Batch normalisation synchronised across devices (reference:
    ``contrib.nn.SyncBatchNorm``). On one device the batch is the whole
    batch, so it is ``BatchNorm``; ``num_devices`` is accepted and
    unused."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        del num_devices
        super().__init__(in_channels=in_channels, **kwargs)


class _ChannelNorm(HybridBlock):
    """A normalisation with a per-channel ``gamma`` and ``beta`` whose
    channel count comes from the input's axis ``self._axis``."""

    def __init__(self, axis, center, scale, beta_initializer,
                 gamma_initializer, in_channels, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def infer_shape(self, x):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)


class LayerNorm(_ChannelNorm):
    """Layer normalisation over ``axis`` (eps 1e-5), ``gamma``/``beta``
    of the normalised axis's size."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(axis, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix=prefix,
                         params=params)
        self._eps = epsilon

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class InstanceNorm(_ChannelNorm):
    """Normalise each sample's channels over their spatial axes. Note the
    reference default ``scale=False``: ``gamma`` stays 1 and takes no
    gradient. The operator normalises axis 1; ``axis`` only sizes the
    parameters, as in the JAX package."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(axis, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)
        self._eps = epsilon

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._eps)


class GroupNorm(_ChannelNorm):
    """Normalise each sample over ``num_groups`` groups of channels (axis
    1) and the spatial axes."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(1, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)
        self._num_groups = num_groups
        self._eps = epsilon

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._eps)


class Lambda(Block):
    """A block around a function of NDArrays, or the name of an ``nd``
    operator."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as F

            function = getattr(F, function)
        self._func_impl = function

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """A hybrid block around ``function(F, *args)``, or the name of an
    ``nd`` operator called as ``F.<name>(*args)``."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name = function
            function = None
        else:
            self._func_name = getattr(function, "__name__", "lambda")
        self._func_impl = function

    def hybrid_forward(self, F, *args):
        if self._func_impl is None:
            return getattr(F, self._func_name)(*args)
        return self._func_impl(F, *args)


class Flatten(HybridBlock):
    """Collapse every axis but the first."""

    def hybrid_forward(self, F, x):
        if getattr(self, "_tpu_nchw_flatten", False) and x.ndim == 4:
            # NHWC interior of an optimize_for'd net: restore NCHW feature
            # order so the flattened vector matches NCHW-trained weights
            x = F.transpose(x, axes=(0, 3, 1, 2))
        return F.flatten(x)

    def __repr__(self):
        return "Flatten"


class Embedding(HybridBlock):
    """Lookup table ``(input_dim, output_dim)``."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"
