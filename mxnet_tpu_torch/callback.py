"""Training callbacks (``mx.callback``; the port's copy of
``mxnet_tpu/callback.py``, reference ``python/mxnet/callback.py``).

``Speedometer``, ``ProgressBar``, ``BatchEndParam`` and
``log_train_metric`` work on any loop. The checkpoint callbacks need the
Module API (ROADMAP A13) and ``TelemetryLogger`` the telemetry registry
(ROADMAP A12): they raise until those are ported.
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
    def __init__(self, *args, **kwargs):
        raise MXNetError("callback.TelemetryLogger needs the telemetry "
                         "registry, which is not ported yet (ROADMAP A12)")
