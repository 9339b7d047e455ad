"""Optimizer update operators (``nd.sgd_update``, ``nd.adam_update``,
``nd.multi_sgd_update``, ...).

PyTorch counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference:
``src/operator/optimizer_op.cc`` and ``optimizer_op-inl.h``): the
single-tensor updates (``sgd_update`` ... ``lamb_update_phase1/2`` and
their ``mp_*`` fp32-master forms) and the multi-tensor family
(``multi_sum_sq``, ``multi_lars``, ``multi_*sgd*``, ``preloaded_multi_*``,
``multi_lamb_update``, ``multi_mp_lamb_update``) with the reference's
interleaved positional layout. Each op is a pure function of tensors that
RETURNS its updated tensors; the ``nd`` wrappers write them back through
``out=`` (``ndarray/op.py``), as the JAX package's dispatcher does.
"""

from __future__ import annotations

import torch

from .registry import register

def _rescale(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


# ---------------------------------------------------------------------------
# single-tensor updates
# ---------------------------------------------------------------------------


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    return weight - lr * g


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    mom_new = momentum * mom - lr * g
    return weight + mom_new, mom_new


def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    g = _rescale(grad.float(), rescale_grad, clip_gradient) \
        + wd * weight32
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _rescale(grad.float(), rescale_grad, clip_gradient) \
        + wd * weight32
    mom_new = momentum * mom - lr * g
    w32 = weight32 + mom_new
    return w32.to(weight.dtype), mom_new, w32


def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _rescale(grad, rescale_grad, clip_gradient)
    return (1.0 - lr * wd) * weight - lr * torch.sign(g)


def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _rescale(grad, rescale_grad, clip_gradient)
    mom_new = momentum * mom - (1.0 - momentum) * g
    w = (1.0 - lr * wd_lh) * weight + lr * torch.sign(mom_new)
    return w, mom_new


def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    mom_new = momentum * mom + g
    return weight - lr * (g + momentum * mom_new), mom_new


def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale(grad.float(), rescale_grad, clip_gradient) \
        + wd * weight32
    mom_new = momentum * mom + g
    w32 = weight32 - lr * (g + momentum * mom_new)
    return w32.to(weight.dtype), mom_new, w32


def ftml_update(weight, grad, d, v, z, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1):
    g = _rescale(grad, rescale_grad, clip_grad) + wd * weight
    v_new = beta2 * v + (1 - beta2) * g * g
    d_new = (1 - beta1 ** t) / lr * (
        torch.sqrt(v_new / (1 - beta2 ** t)) + epsilon)
    sigma = d_new - beta1 * d
    z_new = beta1 * z + (1 - beta1) * g - sigma * weight
    w = -z_new / d_new
    return w, d_new, v_new, z_new


def rmsprop_update(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    n_new = (1.0 - gamma1) * g * g + gamma1 * n
    w = weight - lr * g / torch.sqrt(n_new + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n_new


def rmspropalex_update(weight, grad, n, g_avg, delta, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    g = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    n_new = (1.0 - gamma1) * g * g + gamma1 * n
    g_new = (1.0 - gamma1) * g + gamma1 * g_avg
    delta_new = gamma2 * delta - lr * g / torch.sqrt(
        n_new - g_new * g_new + epsilon)
    w = weight + delta_new
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n_new, g_new, delta_new


def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale(grad, rescale_grad, clip_gradient)
    hist_new = history + g * g
    return weight - lr * (g / torch.sqrt(hist_new + epsilon) + wd * weight), \
        hist_new


def adadelta_update(weight, grad, acc_g, acc_delta, lr=1.0, rho=0.9,
                    epsilon=1e-5, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    acc_g_new = rho * acc_g + (1 - rho) * g * g
    delta = torch.sqrt(acc_delta + epsilon) \
        / torch.sqrt(acc_g_new + epsilon) * g
    acc_delta_new = rho * acc_delta + (1 - rho) * delta * delta
    return weight - delta, acc_g_new, acc_delta_new


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale(grad, rescale_grad, clip_gradient)
    n_new = n + g * g
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z_new = z + g - sigma * weight
    w = torch.where(
        torch.abs(z_new) <= lamda1, torch.zeros_like(weight),
        -(z_new - torch.sign(z_new) * lamda1)
        / ((beta + torch.sqrt(n_new)) / lr + wd))
    return w, z_new, n_new


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * g * g
    return weight - lr * mean_new / (torch.sqrt(var_new) + epsilon), \
        mean_new, var_new


def dcasgd_update(weight, grad, mom, previous_weight, lr, momentum=0.0,
                  lamda=0.04, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Delay-compensated async SGD (reference ``dcasgd_update``)."""
    g = _rescale(grad, rescale_grad, clip_gradient) + wd * weight
    mom_new = momentum * mom - lr * (
        g + lamda * g * g * (weight - previous_weight))
    # a copy: ``out=`` writes the new weight into ``weight`` first
    return weight + mom_new, mom_new, weight.clone()


def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale(grad, rescale_grad, clip_gradient)
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * g * g
    if bias_correction:
        mean_hat = mean_new / (1 - beta1 ** t)
        var_hat = var_new / (1 - beta2 ** t)
    else:
        mean_hat, var_hat = mean_new, var_new
    direction = mean_hat / (torch.sqrt(var_hat) + epsilon) + wd * weight
    return direction, mean_new, var_new


def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    if lower_bound is not None and lower_bound >= 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                      torch.ones_like(r1))
    return weight - lr * ratio * g


def mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    g32 = grad.float()
    direction, mean_new, var_new = lamb_update_phase1(
        weight32, g32, mean, var, beta1=beta1, beta2=beta2, epsilon=epsilon,
        t=t, bias_correction=bias_correction, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    return direction, mean_new, var_new


def mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr, lower_bound=-1.0,
                          upper_bound=-1.0):
    w32 = lamb_update_phase2(weight32, g, r1, r2, lr,
                             lower_bound=lower_bound, upper_bound=upper_bound)
    return w32.to(weight.dtype), w32


# ---------------------------------------------------------------------------
# multi-tensor family (reference layout: interleaved positional inputs)
# ---------------------------------------------------------------------------


def multi_sum_sq(*arrays, num_arrays=None):
    n = num_arrays if num_arrays is not None else len(arrays)
    return torch.stack([torch.sum(a.float() * a.float())
                        for a in arrays[:n]])


def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001,
               eps=1e-8, rescale_grad=1.0):
    """LARS per-layer lr scaling (reference ``multi_lars``)."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    trust = torch.where(
        (w_norm > 0) & (g_norm > 0),
        eta * w_norm / (g_norm + wds * w_norm + eps),
        torch.ones_like(w_norm))
    return lrs * trust


def _split_interleaved(arrays, num_weights, per):
    groups = [arrays[i * per:(i + 1) * per] for i in range(num_weights)]
    return groups


def multi_sgd_update(*arrays, lrs=(), wds=(), num_weights=None,
                     rescale_grad=1.0, clip_gradient=-1.0):
    n = num_weights if num_weights is not None else len(arrays) // 2
    outs = []
    for i, (w, g) in enumerate(_split_interleaved(arrays, n, 2)):
        outs.append(sgd_update(w, g, lrs[i], wd=wds[i],
                               rescale_grad=rescale_grad,
                               clip_gradient=clip_gradient))
    return tuple(outs)


def multi_sgd_mom_update(*arrays, lrs=(), wds=(), momentum=0.0,
                         num_weights=None, rescale_grad=1.0,
                         clip_gradient=-1.0):
    n = num_weights if num_weights is not None else len(arrays) // 3
    outs = []
    for i, (w, g, m) in enumerate(_split_interleaved(arrays, n, 3)):
        w2, m2 = sgd_mom_update(w, g, m, lrs[i], momentum=momentum,
                                wd=wds[i], rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient)
        outs.extend([w2, m2])
    return tuple(outs)


def multi_mp_sgd_update(*arrays, lrs=(), wds=(), num_weights=None,
                        rescale_grad=1.0, clip_gradient=-1.0):
    n = num_weights if num_weights is not None else len(arrays) // 3
    outs = []
    for i, (w, g, w32) in enumerate(_split_interleaved(arrays, n, 3)):
        w2, w32n = mp_sgd_update(w, g, w32, lrs[i], wd=wds[i],
                                 rescale_grad=rescale_grad,
                                 clip_gradient=clip_gradient)
        outs.extend([w2, w32n])
    return tuple(outs)


def multi_mp_sgd_mom_update(*arrays, lrs=(), wds=(), momentum=0.0,
                            num_weights=None, rescale_grad=1.0,
                            clip_gradient=-1.0):
    n = num_weights if num_weights is not None else len(arrays) // 4
    outs = []
    for i, (w, g, m, w32) in enumerate(_split_interleaved(arrays, n, 4)):
        w2, m2, w32n = mp_sgd_mom_update(w, g, m, w32, lrs[i],
                                         momentum=momentum, wd=wds[i],
                                         rescale_grad=rescale_grad,
                                         clip_gradient=clip_gradient)
        outs.extend([w2, m2, w32n])
    return tuple(outs)


def preloaded_multi_sgd_update(*arrays, num_weights=None, rescale_grad=1.0,
                               clip_gradient=-1.0):
    """Like multi_sgd_update but lrs/wds arrive as trailing ARRAYS
    (reference: ``preloaded_multi_sgd_update`` — avoids host sync in
    LARS pipelines)."""
    n = num_weights if num_weights is not None else (len(arrays) - 2) // 2
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i, (w, g) in enumerate(_split_interleaved(arrays[:-2], n, 2)):
        outs.append(sgd_update(w, g, lrs[i], wd=wds[i],
                               rescale_grad=rescale_grad,
                               clip_gradient=clip_gradient))
    return tuple(outs)


def preloaded_multi_sgd_mom_update(*arrays, momentum=0.0, num_weights=None,
                                   rescale_grad=1.0, clip_gradient=-1.0):
    n = num_weights if num_weights is not None else (len(arrays) - 2) // 3
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i, (w, g, m) in enumerate(_split_interleaved(arrays[:-2], n, 3)):
        w2, m2 = sgd_mom_update(w, g, m, lrs[i], momentum=momentum,
                                wd=wds[i], rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient)
        outs.extend([w2, m2])
    return tuple(outs)


def preloaded_multi_mp_sgd_update(*arrays, num_weights=None,
                                  rescale_grad=1.0, clip_gradient=-1.0):
    n = num_weights if num_weights is not None else (len(arrays) - 2) // 3
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i, (w, g, w32) in enumerate(_split_interleaved(arrays[:-2], n, 3)):
        w2, w32n = mp_sgd_update(w, g, w32, lrs[i], wd=wds[i],
                                 rescale_grad=rescale_grad,
                                 clip_gradient=clip_gradient)
        outs.extend([w2, w32n])
    return tuple(outs)


def preloaded_multi_mp_sgd_mom_update(*arrays, momentum=0.0,
                                      num_weights=None, rescale_grad=1.0,
                                      clip_gradient=-1.0):
    n = num_weights if num_weights is not None else (len(arrays) - 2) // 4
    lrs, wds = arrays[-2], arrays[-1]
    outs = []
    for i, (w, g, m, w32) in enumerate(_split_interleaved(arrays[:-2], n, 4)):
        w2, m2, w32n = mp_sgd_mom_update(w, g, m, w32, lrs[i],
                                         momentum=momentum, wd=wds[i],
                                         rescale_grad=rescale_grad,
                                         clip_gradient=clip_gradient)
        outs.extend([w2, m2, w32n])
    return tuple(outs)


def _lamb_one(w, g, m, v, lr, wd, t, beta1, beta2, epsilon, bias_correction,
              rescale_grad, clip_gradient, lower_bound, upper_bound):
    direction, m2, v2 = lamb_update_phase1(
        w, g, m, v, beta1=beta1, beta2=beta2, epsilon=epsilon, t=t,
        bias_correction=bias_correction, wd=wd, rescale_grad=rescale_grad,
        clip_gradient=clip_gradient)
    r1 = torch.linalg.norm(w)
    r2 = torch.linalg.norm(direction)
    w2 = lamb_update_phase2(w, direction, r1, r2, lr,
                            lower_bound=lower_bound, upper_bound=upper_bound)
    return w2, m2, v2


def multi_lamb_update(*arrays, step_count=(), learning_rates=None, wds=None,
                      beta1=0.9, beta2=0.999, epsilon=1e-6,
                      lower_bound=-1.0, upper_bound=-1.0,
                      bias_correction=True, rescale_grad=1.0,
                      clip_gradient=-1.0, num_tensors=None):
    """Multi-tensor LAMB (reference: ``contrib/multi_lamb.cc``
    ``_multi_lamb_update``): interleaved (w, g, mean, var) x n plus
    per-tensor ``learning_rates``/``wds``/``step_count`` attrs; returns
    interleaved (w2, mean2, var2) x n."""
    n = num_tensors if num_tensors is not None else len(arrays) // 4
    outs = []
    for i, (w, g, m, v) in enumerate(_split_interleaved(arrays, n, 4)):
        t = step_count[i] if i < len(step_count) else 1
        w2, m2, v2 = _lamb_one(
            w, g, m, v, learning_rates[i], wds[i], t, beta1, beta2, epsilon,
            bias_correction, rescale_grad, clip_gradient,
            lower_bound, upper_bound)
        outs.extend([w2, m2, v2])
    return tuple(outs)


def multi_mp_lamb_update(*arrays, step_count=(), learning_rates=None,
                         wds=None, beta1=0.9, beta2=0.999, epsilon=1e-6,
                         lower_bound=-1.0, upper_bound=-1.0,
                         bias_correction=True, rescale_grad=1.0,
                         clip_gradient=-1.0, num_tensors=None):
    """Multi-tensor multi-precision LAMB (``_multi_mp_lamb_update``):
    interleaved (w, g, mean, var, w32) x n; math in fp32 master weights,
    returns (w2, mean2, var2, w32_2) x n."""
    n = num_tensors if num_tensors is not None else len(arrays) // 5
    outs = []
    for i, (w, g, m, v, w32) in enumerate(_split_interleaved(arrays, n, 5)):
        t = step_count[i] if i < len(step_count) else 1
        w32n, m2, v2 = _lamb_one(
            w32, g.float(), m, v, learning_rates[i], wds[i], t,
            beta1, beta2, epsilon, bias_correction, rescale_grad,
            clip_gradient, lower_bound, upper_bound)
        outs.extend([w32n.to(w.dtype), m2, v2, w32n])
    return tuple(outs)


#: the registered names, each exposed as ``nd.<name>``
OPS = {
    "sgd_update": sgd_update,
    "sgd_mom_update": sgd_mom_update,
    "mp_sgd_update": mp_sgd_update,
    "mp_sgd_mom_update": mp_sgd_mom_update,
    "signsgd_update": signsgd_update,
    "signum_update": signum_update,
    "nag_mom_update": nag_mom_update,
    "mp_nag_mom_update": mp_nag_mom_update,
    "ftml_update": ftml_update,
    "rmsprop_update": rmsprop_update,
    "rmspropalex_update": rmspropalex_update,
    "adagrad_update": adagrad_update,
    "adadelta_update": adadelta_update,
    "ftrl_update": ftrl_update,
    "adam_update": adam_update,
    "dcasgd_update": dcasgd_update,
    "lamb_update_phase1": lamb_update_phase1,
    "lamb_update_phase2": lamb_update_phase2,
    "mp_lamb_update_phase1": mp_lamb_update_phase1,
    "mp_lamb_update_phase2": mp_lamb_update_phase2,
    "multi_sum_sq": multi_sum_sq,
    "multi_lars": multi_lars,
    "multi_sgd_update": multi_sgd_update,
    "multi_sgd_mom_update": multi_sgd_mom_update,
    "multi_mp_sgd_update": multi_mp_sgd_update,
    "multi_mp_sgd_mom_update": multi_mp_sgd_mom_update,
    "preloaded_multi_sgd_update": preloaded_multi_sgd_update,
    "preloaded_multi_sgd_mom_update": preloaded_multi_sgd_mom_update,
    "preloaded_multi_mp_sgd_update": preloaded_multi_mp_sgd_update,
    "preloaded_multi_mp_sgd_mom_update": preloaded_multi_mp_sgd_mom_update,
    "multi_lamb_update": multi_lamb_update,
    "multi_mp_lamb_update": multi_mp_lamb_update,
    "_sparse_adagrad_update": adagrad_update,
}

for _name, _fn in OPS.items():  # nd.<name> (ndarray/op.py), with out=
    register(_name)(_fn)
