"""Automatic mixed precision (reference: MXNet's ``contrib/amp``).

PyTorch counterpart of ``mxnet_tpu/amp/__init__.py``.

- ``amp.init("bfloat16")`` switches on the cast policy
  (``amp/policy.py``): the ops of ``policy.FP32_OPS`` run in fp32 while
  the rest computes in the activations' type. bfloat16 keeps fp32's
  exponent range and trains unscaled.
- ``amp.init("float16")`` with ``amp.init_trainer(trainer)`` adds a
  dynamic :class:`LossScaler`. Its scale, stable-step count and overflow
  total are device scalars: ``gluon.Trainer``'s fused update checks the
  gradients for non-finite values in one reduction, unscales them in
  fp32, skips the whole update when one is found (weights, fp32 masters
  and every optimizer state leaf stay as they were, bit for bit) and
  backs the scale off or grows it, all on the device with no host
  synchronisation. The per-parameter path does the same with one
  synchronisation.
- Master weights: ``multi_precision=True`` on the optimizer or Trainer
  keeps an fp32 copy of each bfloat16/float16 weight (state leaf 0 of
  the fused update; the eager ``(master, state)`` pair).
- ``gluon.Superstep`` carries the scaler through its K iterations: each
  iteration checks, skips and adjusts the scale on its own, so one
  overflowing batch skips only its own iteration. The scaler's counters
  move once per superstep as seen from the host.
"""

from __future__ import annotations

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from . import policy
from .policy import FP32_OPS, is_enabled  # noqa: F401  (policy surface)

# the SAME dict policy.py owns: every check reads it
_STATE = policy._STATE


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP (bfloat16 by default). ``fp32_ops`` extends the fp32
    list; ``target_precision_ops`` and ``conditional_fp32_ops`` are
    accepted for the reference's signature (ops already compute in their
    inputs' type)."""
    del target_precision_ops, conditional_fp32_ops
    if target_dtype not in ("bfloat16", "float16"):
        raise MXNetError("target_dtype must be bfloat16 or float16")
    policy.set_policy(target_dtype, fp32_ops=fp32_ops)


def disable():
    """Turn the cast policy off."""
    policy.clear_policy()


def target_dtype():
    return _STATE["target_dtype"]


def init_trainer(trainer):
    """Attach a loss scaler for float16; nothing for bfloat16."""
    if _STATE["target_dtype"] == "float16":
        trainer._amp_loss_scaler = LossScaler()
    return trainer


def _norm_block_types():
    from ..gluon.nn.basic_layers import (BatchNorm, GroupNorm, InstanceNorm,
                                         LayerNorm)

    return (BatchNorm, LayerNorm, InstanceNorm, GroupNorm)


def convert_model(net, target_dtype=None):
    """Cast a Gluon block to the AMP type, keeping the norm layers
    (BatchNorm, LayerNorm, InstanceNorm, GroupNorm: parameters and running
    statistics) in fp32; the ops cast them to the activations' type where
    they are used."""
    dtype = target_dtype or _STATE["target_dtype"] or "bfloat16"
    net.cast(dtype)
    norm_types = _norm_block_types()

    def repin(block):
        if isinstance(block, norm_types):
            block.cast("float32")

    net.apply(repin)
    return net


convert_hybrid_block = convert_model


def _collect_grad_raws(params):
    """Gradient tensors of a mixed list of Parameters, NDArrays with an
    attached gradient, and plain arrays (whose values are inspected)."""
    raws = []
    for p in params:
        grad_attr = getattr(p, "grad", None)
        if callable(grad_attr):
            g = grad_attr()
        elif grad_attr is not None:
            g = grad_attr
        else:
            g = p
        if g is None:
            continue
        raws.append(g.data if isinstance(g, NDArray) else torch.as_tensor(g))
    return raws


def _any_nonfinite(raws):
    """One reduction over the whole gradient set: a device bool."""
    return torch.logical_not(torch.stack(
        [torch.isfinite(g).all() for g in raws]).all())


class LossScaler:
    """Dynamic loss scaling (reference: ``loss_scaler.py``), for float16.

    The scale, the stable-step count and the overflow total are 0-d
    device tensors (on the device of the gradients they meet first), so
    the fused update reads and writes them with no host synchronisation;
    ``loss_scale`` and ``overflow_total`` synchronise to read them."""

    def __init__(self, init_scale=2 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self._factor = float(scale_factor)
        self._window = int(scale_window)
        self._scale_arr = torch.tensor(float(init_scale),
                                       dtype=torch.float32)
        self._unskipped_arr = torch.tensor(0, dtype=torch.int32)
        self._overflow_total_arr = torch.tensor(0, dtype=torch.int32)

    def _on(self, device):
        """Move the three counters to ``device`` (once); returns self."""
        if self._scale_arr.device != device:
            self._scale_arr = self._scale_arr.to(device)
            self._unskipped_arr = self._unskipped_arr.to(device)
            self._overflow_total_arr = self._overflow_total_arr.to(device)
        return self

    @property
    def loss_scale(self):
        return float(self._scale_arr)

    @loss_scale.setter
    def loss_scale(self, value):
        self._scale_arr = torch.tensor(float(value), dtype=torch.float32,
                                       device=self._scale_arr.device)

    @property
    def _unskipped(self):
        return int(self._unskipped_arr)

    @property
    def overflow_total(self):
        return int(self._overflow_total_arr)

    def has_overflow(self, params):
        """True if any gradient holds a non-finite value: one reduction
        and one synchronisation, whatever the number of parameters."""
        raws = _collect_grad_raws(params)
        if not raws:
            return False
        return bool(_any_nonfinite(raws))

    def update_scale(self, overflow):
        """Host-side scale adjustment (the per-parameter path; the fused
        update does the same arithmetic on the device)."""
        scale = float(self._scale_arr)
        unskipped = int(self._unskipped_arr)
        total = int(self._overflow_total_arr)
        if overflow:
            scale = max(scale / self._factor, 1.0)
            unskipped = 0
            total += 1
        else:
            unskipped += 1
            if unskipped >= self._window:
                scale *= self._factor
                unskipped = 0
        dev = self._scale_arr.device
        self._scale_arr = torch.tensor(scale, dtype=torch.float32,
                                       device=dev)
        self._unskipped_arr = torch.tensor(unskipped, dtype=torch.int32,
                                           device=dev)
        self._overflow_total_arr = torch.tensor(total, dtype=torch.int32,
                                                device=dev)
        from .. import observability as _obs

        if _obs.ENABLED:
            _obs.record_amp_scale(scale, total, bool(overflow))


class scale_loss:
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``

    The loss (promoted to fp32, as the reference's ``loss * scale``
    promotes) is multiplied by the current scale, a device scalar: no
    synchronisation. Unscaling, the overflow check, the skip and the
    scale update wait for ``trainer.step``. Between ``backward()`` and
    ``step()`` the gradient buffers hold scaled values (and after a fused
    ``step()`` too: the fused update unscales copies); ``amp.unscale``
    divides them in place. A scaled backward discarded without a
    ``step()`` needs ``amp.unscale(trainer)`` or a ``step``, or the next
    step divides unscaled gradients by the scale."""

    def __init__(self, loss, trainer):
        self._loss = loss
        self._trainer = trainer
        self._scaler = getattr(trainer, "_amp_loss_scaler", None)

    def _scaled(self, loss):
        t = loss.data
        scale = self._scaler._on(t.device)._scale_arr
        if t.dtype != torch.float32 and t.is_floating_point() \
                and t.element_size() < 4:
            loss = loss.astype("float32")
        return loss * NDArray(scale)

    def __enter__(self):
        if self._scaler is None:
            return self._loss
        if isinstance(self._loss, (list, tuple)):
            return [self._scaled(l) for l in self._loss]
        return self._scaled(self._loss)

    def __exit__(self, exc_type, *exc):
        if self._scaler is not None and exc_type is None:
            self._trainer._amp_pending = "scaled"
        return False


def unscale(trainer):
    """Divide the attached gradients by the pending loss scale now (for
    inspecting or clipping them between ``backward()`` and ``step()``).
    Does nothing unless a ``scale_loss`` block just ran. The pending
    state moves to ``"unscaled"``: the next ``trainer.step`` still checks
    for overflow, skips and updates the scale (an inf stays inf through
    the division), and does not divide again."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None or getattr(trainer, "_amp_pending", False) != "scaled":
        return
    trainer._amp_pending = "unscaled"
    outs = []
    for p in trainer._params:
        if p.grad_req == "null" or p._data is None:
            continue
        outs.extend(g for g in p.list_grad() if g is not None)
    if not outs:
        return
    inv = 1.0 / scaler._on(outs[0].data.device)._scale_arr
    with torch.no_grad():
        for g in outs:
            g.data.mul_(inv.to(g.data.dtype))
