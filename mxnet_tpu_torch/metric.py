"""Evaluation metrics (``mx.metric``), on the host.

The port's copy of ``mxnet_tpu/metric.py`` (reference:
``python/mxnet/metric.py``): each metric takes labels and predictions as
NDArrays, torch tensors or numpy arrays and accumulates in numpy; a
bfloat16 tensor is read as float32.
"""

from __future__ import annotations

import numpy as _np
import torch

from .base import MXNetError

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def _as_np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return _np.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if not shape:
        if len(labels) != len(preds):
            raise ValueError(
                f"Shape of labels {len(labels)} does not match preds "
                f"{len(preds)}"
            )


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def get_config(self):
        config = dict(self._kwargs)
        config.update(
            {"metric": self.__class__.__name__, "name": self.name,
             "output_names": self.output_names,
             "label_names": self.label_names}
        )
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    @staticmethod
    def create(metric, *args, **kwargs):
        return create(metric, *args, **kwargs)


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    aliases = {"acc": "accuracy", "ce": "crossentropy",
               "top_k_accuracy": "topkaccuracy", "top_k_acc": "topkaccuracy",
               "pearsonr": "pearsoncorrelation", "nll_loss": "crossentropy"}
    key = aliases.get(metric.lower(), metric.lower())
    if key not in _REGISTRY:
        raise MXNetError(f"unknown metric {metric}")
    return _REGISTRY[key](*args, **kwargs)


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, list):
                names.extend(name)
            else:
                names.append(name)
            if isinstance(value, list):
                values.extend(value)
            else:
                values.append(value)
        return (names, values)


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, axis=axis, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            p = _as_np(pred)
            l = _as_np(label).astype("int32")
            if p.ndim > l.ndim:
                p = p.argmax(axis=self.axis)
            p = p.astype("int32").reshape(-1)
            l = l.reshape(-1)
            self.sum_metric += float((p == l).sum())
            self.num_inst += len(l)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(name, top_k=top_k, **kwargs)
        self.top_k = top_k
        self.name += f"_{top_k}"

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            p = _np.argsort(-_as_np(pred), axis=1)[:, : self.top_k]
            l = _as_np(label).astype("int32").reshape(-1)
            self.sum_metric += float((p == l[:, None]).any(axis=1).sum())
            self.num_inst += len(l)


class _F1Base(EvalMetric):
    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = self.tn = 0.0

    def _accumulate(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            p = _as_np(pred)
            if p.ndim > 1 and p.shape[-1] > 1:
                p = p.argmax(axis=-1)
            else:
                p = (p.reshape(-1) > 0.5).astype("int32")
            l = _as_np(label).astype("int32").reshape(-1)
            p = p.astype("int32").reshape(-1)
            self.tp += float(((p == 1) & (l == 1)).sum())
            self.fp += float(((p == 1) & (l == 0)).sum())
            self.fn += float(((p == 0) & (l == 1)).sum())
            self.tn += float(((p == 0) & (l == 0)).sum())
            self.num_inst += len(l)


@register
class F1(_F1Base):
    def __init__(self, name="f1", average="macro", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        self._accumulate(labels, preds)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        prec = self.tp / max(self.tp + self.fp, 1e-12)
        rec = self.tp / max(self.tp + self.fn, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return (self.name, f1)


@register
class MCC(_F1Base):
    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        self._accumulate(labels, preds)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        num = self.tp * self.tn - self.fp * self.fn
        den = _np.sqrt(
            (self.tp + self.fp) * (self.tp + self.fn)
            * (self.tn + self.fp) * (self.tn + self.fn)
        )
        return (self.name, num / den if den > 0 else 0.0)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            l, p = _as_np(label), _as_np(pred)
            if l.shape != p.shape:
                l = l.reshape(p.shape)
            self.sum_metric += float(_np.abs(l - p).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            l, p = _as_np(label), _as_np(pred)
            if l.shape != p.shape:
                l = l.reshape(p.shape)
            self.sum_metric += float(((l - p) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        EvalMetric.__init__(self, name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, _np.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, eps=eps, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            l = _as_np(label).astype("int32").reshape(-1)
            p = _as_np(pred).reshape(len(l), -1)
            prob = p[_np.arange(len(l)), l]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += len(l)


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        EvalMetric.__init__(self, name, **kwargs)
        self.ignore_label = ignore_label
        self.eps = 1e-12

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            l = _as_np(label).astype("int32").reshape(-1)
            p = _as_np(pred).reshape(len(l), -1)
            prob = p[_np.arange(len(l)), l]
            logp = -_np.log(prob + self.eps)
            if self.ignore_label is not None:
                keep = l != self.ignore_label
                logp = logp[keep]
                self.num_inst += int(keep.sum())
            else:
                self.num_inst += len(l)
            self.sum_metric += float(logp.sum())

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(_np.exp(self.sum_metric / self.num_inst)))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            l = _as_np(label).reshape(-1)
            p = _as_np(pred).reshape(-1)
            self.sum_metric += float(_np.corrcoef(l, p)[0, 1])
            self.num_inst += 1


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        preds = preds if isinstance(preds, list) else [preds]
        for pred in preds:
            loss = _as_np(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False, **kwargs):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", "custom")
    return CustomMetric(feval, name, allow_extra_outputs)
