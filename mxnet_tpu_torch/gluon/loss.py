"""Gluon losses (reference: ``mxnet_tpu/gluon/loss.py``)."""

from __future__ import annotations

from .block import HybridBlock


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy. With sparse labels and logits it is the
    ``logsumexp - pick`` form in fp32, which never materialises the
    log-probabilities; labels may be float (they are cast for ``pick``).
    The result is the mean over every axis but the batch axis."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if self._sparse_label and not self._from_logits:
            lse = F.logsumexp(F.cast(pred, dtype="float32"),
                              axis=self._axis, keepdims=True)
            picked = F.pick(pred, label, axis=self._axis, keepdims=True)
            loss = lse - F.cast(picked, dtype="float32")
        else:
            if not self._from_logits:
                pred = F.log_softmax(pred, axis=self._axis)
            if self._sparse_label:
                loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
            else:
                label = F.reshape_like(label, pred)
                loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
