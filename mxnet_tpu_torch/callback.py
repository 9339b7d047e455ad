"""Training callbacks (``mx.callback``; the port's copy of
``mxnet_tpu/callback.py``, reference ``python/mxnet/callback.py``).

``Speedometer``, ``ProgressBar``, ``BatchEndParam``, ``log_train_metric``
and ``TelemetryLogger`` (the telemetry summary) work on any loop. The
checkpoint callbacks need the Module API (ROADMAP A13): they raise until
it is ported.
"""

from __future__ import annotations

import logging
import time

from .base import MXNetError


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    raise MXNetError("callback.module_checkpoint needs the Module API, "
                     "which is not ported yet (ROADMAP A13)")


def do_checkpoint(prefix, period=1):
    raise MXNetError("callback.do_checkpoint needs the Module API's "
                     "save_checkpoint, which is not ported yet (ROADMAP A13)")


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Logs samples/sec every ``frequent`` batches (reference:
    ``callback.py:Speedometer``)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size \
                    / (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = (f"Epoch[{param.epoch}] Batch [{count}]\t"
                           f"Speed: {speed:.2f} samples/sec")
                    for n, v in name_value:
                        msg += f"\t{n}={v:f}"
                    logging.info(msg)
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f "
                                 "samples/sec", param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")


class BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class TelemetryLogger:
    """Epoch-end callback logging the observability telemetry summary
    (the classic-``callback`` counterpart of
    ``observability.TelemetryHandler`` for ``Module.fit``-style loops).

    Usable both as an ``epoch_end_callback(iter_no, sym, arg, aux)`` and
    as a ``batch_end_callback(param)`` (it inspects its arguments).
    """

    def __init__(self, period=1, logger=None, reset_trace=False):
        self.period = int(max(1, period))
        self.logger = logger or logging.getLogger("telemetry")
        self.reset_trace = reset_trace
        self._count = 0

    def __call__(self, *cb_args, **cb_kwargs):
        from . import observability

        self._count += 1
        if self._count % self.period:
            return
        head = cb_args[0] if cb_args else None
        if isinstance(head, BatchEndParam):
            tag = f"[Epoch {head.epoch}] Batch [{head.nbatch}] "
        elif isinstance(head, int):
            tag = f"[Epoch {head}] "
        else:
            tag = ""
        self.logger.info("%s%s", tag, observability.summary())
        if self.reset_trace:
            observability.tracer().clear()
