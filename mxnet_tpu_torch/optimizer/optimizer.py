"""Optimizers: the per-parameter update rules of the Gluon Trainer.

PyTorch counterpart of ``mxnet_tpu/optimizer/optimizer.py``, every
registered optimizer with the same arithmetic, term for term: the
gradient is scaled by ``rescale_grad`` and clipped to ``clip_gradient``
first; weight decay is coupled (added to the gradient) except in AdamW
and Signum's ``wd_lh``; Adam folds its bias correction into the learning
rate and adds epsilon outside the square root. Updates are written in
place into the weight and state tensors (the JAX package rebinds
immutable buffers). Arguments the reference takes and does not use
(``sym``, unknown keywords) are accepted and ignored, as there.

``multi_precision`` keeps an fp32 master of a bfloat16/float16 weight
(``create_state_multi_precision``/``update_multi_precision``); the
Trainer's fused path updates through ``multi_tensor.update`` instead.
"""

from __future__ import annotations

import pickle

import torch

from .. import random as _random
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .multi_tensor import is_low_precision_dtype

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def _zeros(weight, dtype=None):
    return NDArray(torch.zeros_like(weight.data.detach(), dtype=dtype))


def _set(arr, value):
    """Write ``value`` into ``arr``'s tensor in place (its dtype kept)."""
    arr.data.copy_(value)


class Optimizer:
    """Base optimizer: learning rate (or an ``lr_scheduler``) and weight
    decay with per-parameter multipliers, gradient rescaling and
    clipping, and per-index update counts (reference: ``Optimizer``)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, **kwargs):
        del sym, kwargs  # accepted and unused, as in the reference
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        # index -> Parameter, for its lr_mult and wd_mult (set by Trainer)
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    # -- registry ---------------------------------------------------------
    @staticmethod
    def register(klass):
        return register(klass)

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in _REGISTRY:
            raise MXNetError(f"unknown optimizer {name}")
        return _REGISTRY[name.lower()](**kwargs)

    # -- lr/wd ------------------------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; cannot set learning_rate")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # -- state ------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def _low_precision(self, weight) -> bool:
        return self.multi_precision and is_low_precision_dtype(
            weight.data.dtype)

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision`` a bfloat16/float16 weight gets an fp32
        master: the state is ``(master, state of the master)``."""
        if self._low_precision(weight):
            master = NDArray(weight.data.detach().to(torch.float32))
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # -- update -----------------------------------------------------------
    def _preprocess(self, grad):
        g = grad.data * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state):
        if self._low_precision(weight):
            master, st = state
            self.update(index, master, NDArray(grad.data.float()), st)
            weight._set_data(master.data)
        else:
            self.update(index, weight, grad, state)


create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum * mom - lr * (g + wd * w);
    w += mom`` (reference kernels ``sgd_update`` / ``sgd_mom_update``).
    ``lazy_update`` is the identity on dense gradients."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

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
class NAG(SGD):
    """Nesterov momentum: ``mom = momentum * mom + g; w -= lr * (g +
    momentum * mom)``, with ``g`` the decayed gradient."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight.data
        g = self._preprocess(grad) + wd * w
        if state is None:
            _set(weight, w - lr * g)
        else:
            mom = self.momentum * state.data + g
            _set(state, mom)
            _set(weight, w - lr * (g + self.momentum * mom))


@register
class Signum(Optimizer):
    """Sign of the momentum (``signum_update``), with ``wd_lh`` decoupled
    decay."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess(grad)
        w = weight.data
        if state is not None:
            mom = self.momentum * state.data - (1 - self.momentum) * (
                g + wd * w)
            _set(state, mom)
            _set(weight, (1 - lr * self.wd_lh) * w + lr * torch.sign(mom))
        else:
            _set(weight, (1 - lr * self.wd_lh) * w
                 - lr * torch.sign(g + wd * w))


@register
class Adam(Optimizer):
    """Adam (reference kernel ``adam_update``): weight decay added to the
    gradient, bias correction folded into ``lr``. ``lazy_update`` is the
    identity on dense gradients."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def _lr_t(self, index):
        lr = self._get_lr(index)
        t = self._index_update_count[index]
        return lr * (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)

    def _moments(self, g, state):
        m, v = state[0].data, state[1].data
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
        return m, v

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr_t, wd = self._lr_t(index), self._get_wd(index)
        w = weight.data
        m, v = self._moments(self._preprocess(grad) + wd * w, state)
        w.sub_(lr_t * m / (torch.sqrt(v) + self.epsilon))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay: ``w -= lr * wd * w`` beside the
    Adam step."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr_t = self._lr_t(index)
        w = weight.data
        m, v = self._moments(self._preprocess(grad), state)
        _set(weight, w - lr_t * m / (torch.sqrt(v) + self.epsilon)
             - lr * wd * w)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess(grad) + wd * weight.data
        hist = state.data + torch.square(g)
        _set(state, hist)
        _set(weight, weight.data - lr * g / (torch.sqrt(hist)
                                             + self.float_stable_eps))


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = self._preprocess(grad) + wd * weight.data
        acc_g, acc_delta = state
        ag = self.rho * acc_g.data + (1 - self.rho) * torch.square(g)
        delta = torch.sqrt(acc_delta.data + self.epsilon) \
            / torch.sqrt(ag + self.epsilon) * g
        ad = self.rho * acc_delta.data + (1 - self.rho) * torch.square(delta)
        _set(acc_g, ag)
        _set(acc_delta, ad)
        _set(weight, weight.data - delta)


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess(grad) + wd * weight.data
        nv = (1 - self.gamma1) * torch.square(g) + self.gamma1 \
            * state[0].data
        if not self.centered:
            w = weight.data - lr * g / torch.sqrt(nv + self.epsilon)
        else:
            n, gmean, delta = state
            gv = (1 - self.gamma1) * g + self.gamma1 * gmean.data
            dv = self.gamma2 * delta.data - lr * g / torch.sqrt(
                nv - torch.square(gv) + self.epsilon)
            _set(gmean, gv)
            _set(delta, dv)
            w = weight.data + dv
        _set(state[0], nv)
        if self.clip_weights:
            w = torch.clamp(w, -self.clip_weights, self.clip_weights)
        _set(weight, w)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess(grad)
        z, n = state
        sigma = (torch.sqrt(n.data + torch.square(g))
                 - torch.sqrt(n.data)) / lr
        zv = z.data + g - sigma * weight.data
        nv = n.data + torch.square(g)
        _set(z, zv)
        _set(n, nv)
        _set(weight, torch.where(
            torch.abs(zv) <= self.lamda1, torch.zeros_like(zv),
            -(zv - torch.sign(zv) * self.lamda1)
            / ((self.beta + torch.sqrt(nv)) / lr + wd)))


@register
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(_zeros(weight) for _ in range(3))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        g = self._preprocess(grad) + wd * weight.data
        d, v, zs = state
        vv = self.beta2 * v.data + (1 - self.beta2) * torch.square(g)
        d_t = (1 - self.beta1 ** t) / lr * (
            torch.sqrt(vv / (1 - self.beta2 ** t)) + self.epsilon)
        sigma = d_t - self.beta1 * d.data
        zv = self.beta1 * zs.data + (1 - self.beta1) * g \
            - sigma * weight.data
        _set(v, vv)
        _set(d, d_t)
        _set(zs, zv)
        _set(weight, -zv / d_t)


@register
class LARS(SGD):
    """Layer-wise adaptive rate scaling (reference: ``lars_*`` kernels);
    the trust ratio stays on the device."""

    def __init__(self, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.eta = eta
        self.epsilon = epsilon

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess(grad)
        w = weight.data
        w_norm = torch.linalg.norm(w)
        g_norm = torch.linalg.norm(g)
        ratio = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon),
            torch.ones_like(w_norm))
        lr_eff = lr * ratio
        if state is None:
            _set(weight, w - lr_eff * (g + wd * w))
        else:
            mom = self.momentum * state.data - lr_eff * (g + wd * w)
            _set(state, mom)
            _set(weight, w + mom)


@register
class LAMB(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        g = self._preprocess(grad)
        m, v = state
        m_t = self.beta1 * m.data + (1 - self.beta1) * g
        v_t = self.beta2 * v.data + (1 - self.beta2) * torch.square(g)
        _set(m, m_t)
        _set(v, v_t)
        if self.bias_correction:
            m_hat = m_t / (1 - self.beta1 ** t)
            v_hat = v_t / (1 - self.beta2 ** t)
        else:
            m_hat, v_hat = m_t, v_t
        r = m_hat / (torch.sqrt(v_hat) + self.epsilon) + wd * weight.data
        w_norm = torch.linalg.norm(weight.data)
        r_norm = torch.linalg.norm(r)
        if self.lower_bound is not None:
            w_norm = torch.clamp(w_norm, min=self.lower_bound)
        if self.upper_bound is not None:
            w_norm = torch.clamp(w_norm, max=self.upper_bound)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        _set(weight, weight.data - lr * ratio * r)


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: the state keeps the previous weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        return (None if self.momentum == 0.0 else _zeros(weight),
                NDArray(weight.data.detach().clone()))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess(grad)
        mom, prev = state
        w = weight.data
        delta = -lr * (g + wd * w + self.lamda * g * g * (w - prev.data))
        if mom is not None:
            delta = self.momentum * mom.data + delta
            _set(mom, delta)
        _set(prev, w)
        _set(weight, w + delta)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half a gradient step plus
    Gaussian noise of variance ``lr``. The noise comes from the
    optimizer's own ``torch.Generator`` on the weight's device, seeded at
    its first draw with ``torch.initial_seed()`` (the seed of the port's
    global stream, ``torch.manual_seed``), and seeded again at its next
    draw after every ``mx.random.seed``, so a seed repeats the noise as
    the JAX package's key stream does."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._generators = {}

    def _generator(self, device):
        epoch = _random.seed_epoch()
        gen = self._generators.get(device)
        if gen is None or gen[1] != epoch:
            gen = self._generators[device] = (torch.Generator(
                device=device).manual_seed(torch.initial_seed()), epoch)
        return gen[0]

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight.data
        g = self._preprocess(grad) + wd * w
        noise = torch.randn(w.shape, dtype=w.dtype, device=w.device,
                            generator=self._generator(w.device)) * lr ** 0.5
        _set(weight, w - lr / 2 * g + noise)


class Updater:
    """Applies an optimizer by index, creating each index's state on its
    first call (reference: ``optimizer.py:Updater``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        del dump_optimizer
        return pickle.dumps(self.states)

    def set_states(self, states):
        self.states = pickle.loads(states)


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one accumulator per row (reference: contrib
    ``GroupAdaGrad``): every element of a row shares its history. Weight
    decay is refused, as in the reference."""

    def __init__(self, eps=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        if weight.data.dim() < 1:
            raise ValueError("GroupAdaGrad needs >= 1-dim weights")
        return NDArray(torch.zeros((weight.shape[0],), dtype=torch.float32,
                                   device=weight.data.device))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        if self._get_wd(index) != 0.0:
            raise MXNetError("GroupAdaGrad does not support weight decay "
                             "(reference contract: wd must be 0)")
        g = self._preprocess(grad)
        if g.dim() > 1:
            hist = state.data + torch.mean(torch.square(g),
                                           dim=tuple(range(1, g.dim())))
        else:
            hist = state.data + torch.square(g)
        _set(state, hist)
        # the reference kernel: div = sqrt(hist + eps), not sqrt(hist) + eps
        div = torch.sqrt(hist + self.float_stable_eps)
        shape = (-1,) + (1,) * (g.dim() - 1)
        _set(weight, weight.data - lr * g / div.reshape(shape).to(g.dtype))


@register
class LBSGD(Optimizer):
    """Large-batch SGD: a LARS trust ratio capped at 2 and a warmup of
    the lr multiplier from 1 to ``batch_scale``."""

    def __init__(self, momentum=0.0, warmup_strategy="linear",
                 warmup_epochs=5, batch_scale=1, updates_per_epoch=32,
                 begin_epoch=0, num_epochs=60, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = max(batch_scale, 1)
        self.updates_per_epoch = max(updates_per_epoch, 1)
        self.init_updates = begin_epoch * self.updates_per_epoch
        self.num_epochs = num_epochs

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight, torch.float32)

    def _warmup_scale(self, nup):
        total_warm = self.warmup_epochs * self.updates_per_epoch
        if total_warm <= 0 or nup >= total_warm:
            return float(self.batch_scale)
        frac = nup / total_warm
        if self.warmup_strategy == "power2":
            frac = frac ** 2
        elif self.warmup_strategy == "sqrt":
            frac = frac ** 0.5
        if self.batch_scale > 1:
            return 1.0 + (self.batch_scale - 1.0) * frac
        return max(frac, 1.0 / total_warm)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        nup = self._index_update_count.get(index, 1) + self.init_updates
        g = self._preprocess(grad).float()
        w32 = weight.data.float()
        wnorm = torch.linalg.norm(w32)
        gnorm = torch.linalg.norm(g)
        lars = torch.where((wnorm > 0) & (gnorm > 0),
                           torch.clamp(wnorm / (gnorm + wd * wnorm + 1e-9),
                                       max=2.0),
                           torch.ones_like(wnorm))
        eff_lr = lr * self._warmup_scale(nup) * lars
        g = g + wd * w32
        if self.momentum and state is not None:
            m = self.momentum * state.data - eff_lr * g
            _set(state, m)
            _set(weight, w32 + m)
        else:
            _set(weight, w32 - eff_lr * g)


def get_updater(optimizer):
    return Updater(optimizer)
