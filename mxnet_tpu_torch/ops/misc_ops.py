"""The AMP operators of the reference's ``ops/misc_ops.py``.

PyTorch counterpart of six registry names of ``mxnet_tpu/ops/misc_ops.py``
(reference MXNet: ``amp_cast.cc``, ``contrib/all_finite.cc``,
``contrib/adamw.cc``): ``amp_cast``, ``amp_multicast``, ``all_finite``,
``multi_all_finite``, ``mp_adamw_update`` and ``multi_mp_adamw_update``.
Each returns new tensors, as the reference's do. The rest of that module
is ROADMAP A13's.
"""

from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register


def _dtype(name):
    return getattr(torch, str(name).replace("torch.", ""))


@register("amp_cast")
def amp_cast(data, dtype="float32"):
    """AMP graph-rewrite cast; the gradient is cast back."""
    return data.to(_dtype(dtype))


_ORDER = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


@register("amp_multicast")
def amp_multicast(*arrays, num_outputs=None, cast_narrow=False):
    """Cast every input to the widest (``cast_narrow``: the narrowest)
    floating type among them; integer inputs raise."""
    del num_outputs

    def rank(dt):
        if dt not in _ORDER:
            raise MXNetError(
                f"amp_multicast expects floating inputs; got {dt}")
        return _ORDER.index(dt)

    dtypes = [a.dtype for a in arrays]
    pick = min(dtypes, key=rank) if cast_narrow else max(dtypes, key=rank)
    outs = tuple(a.to(pick) for a in arrays)
    return outs if len(outs) > 1 else outs[0]


@register("all_finite")
def all_finite(data, init_output=True):
    """``[1.]`` when every element is finite, else ``[0.]``."""
    del init_output
    return torch.isfinite(data).all().to(torch.float32).reshape((1,))


@register("multi_all_finite")
def multi_all_finite(*arrays, num_arrays=None, init_output=True):
    """``all_finite`` of a list of tensors, in one reduction."""
    del init_output
    n = num_arrays if num_arrays is not None else len(arrays)
    ok = torch.stack([torch.isfinite(a).all() for a in arrays[:n]]).all()
    return ok.to(torch.float32).reshape((1,))


def _adamw(weight, grad, mean, var, rescale_grad, lr, beta1, beta2,
           epsilon, wd, eta, clip_gradient):
    """AdamW with decoupled weight decay (Loshchilov and Hutter), the
    reference's ``adamw_update``; ``rescale_grad`` may be a tensor."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * g * g
    w_new = weight - eta * (lr * mean_new / (torch.sqrt(var_new) + epsilon)
                            + wd * weight)
    return w_new, mean_new, var_new


@register("mp_adamw_update",
          aliases=("_mp_adamw_update", "_contrib_mp_adamw_update"))
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad,
                    lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                    eta=1.0, clip_gradient=-1.0):
    """AdamW on the fp32 master ``weight32`` of a low-precision weight;
    returns ``(weight, mean, var, weight32)``."""
    w32, m2, v2 = _adamw(weight32, grad.to(torch.float32), mean, var,
                         rescale_grad, lr, beta1, beta2, epsilon, wd, eta,
                         clip_gradient)
    return w32.to(weight.dtype), m2, v2, w32


@register("multi_mp_adamw_update")
def multi_mp_adamw_update(*arrays, lrs=None, wds=None, etas=None,
                          rescale_grad=1.0, beta1=0.9, beta2=0.999,
                          epsilon=1e-8, clip_gradient=-1.0,
                          num_tensors=None):
    """``mp_adamw_update`` over interleaved ``(w, g, mean, var, w32)``
    groups; returns the four outputs of each group in turn."""
    n = num_tensors if num_tensors is not None else len(arrays) // 5
    outs = []
    for i in range(n):
        w, g, m, v, w32 = arrays[5 * i:5 * i + 5]
        outs.extend(mp_adamw_update(
            w, g, m, v, w32, rescale_grad, lr=lrs[i], wd=wds[i],
            eta=(etas[i] if etas else 1.0), beta1=beta1, beta2=beta2,
            epsilon=epsilon, clip_gradient=clip_gradient))
    return tuple(outs)
