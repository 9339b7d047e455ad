"""Port parity: ``mx.metric`` and ``mx.callback`` against the JAX
package's, on the same numpy inputs from a seed, fed as NDArrays of each
package (the port's metrics also as torch tensors and numpy arrays).

Metrics accumulate on the host in numpy on both sides, from the same
float32 values: results within 1e-6 relative (float64 sums over float32
inputs; ``np.corrcoef`` and logs of the same values).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

RTOL = 1e-6


def _data(seed=0, n=12, k=5):
    rs = np.random.RandomState(seed)
    logits = rs.randn(n, k).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    labels = rs.randint(0, k, (n,)).astype(np.float32)
    return {"prob": prob.astype(np.float32), "labels": labels,
            "binary": rs.randint(0, 2, (n,)).astype(np.float32),
            "score": rs.rand(n).astype(np.float32),
            "two": np.stack([1 - rs.rand(n), rs.rand(n)], 1)
            .astype(np.float32),
            "reg": rs.randn(n, 1).astype(np.float32),
            "reg_pred": rs.randn(n).astype(np.float32),
            "loss": rs.rand(n, 3).astype(np.float32)}


# metric name, constructor kwargs, (label key, pred key) per update
METRICS = [
    ("acc", {}, [("labels", "prob")]),
    ("accuracy", {"axis": 1}, [("labels", "prob"), ("labels", "labels")]),
    ("top_k_acc", {"top_k": 3}, [("labels", "prob")]),
    ("f1", {}, [("binary", "two"), ("binary", "score")]),
    ("mcc", {}, [("binary", "score")]),
    ("mae", {}, [("reg", "reg_pred")]),
    ("mse", {}, [("reg", "reg_pred"), ("score", "score")]),
    ("rmse", {}, [("reg", "reg_pred")]),
    ("ce", {}, [("labels", "prob")]),
    ("nll_loss", {"eps": 1e-8}, [("labels", "prob")]),
    ("perplexity", {"ignore_label": 2}, [("labels", "prob")]),
    ("perplexity", {}, [("labels", "prob")]),
    ("pearsonr", {}, [("score", "reg_pred")]),
    ("loss", {}, [("labels", "loss")]),
    (["acc", "ce"], {}, [("labels", "prob")]),
]


def _run(mxmod, name, kwargs, updates, wrap):
    metric = mxmod.metric.create(name, **kwargs)
    data = _data()
    for lk, pk in updates:
        metric.update([wrap(data[lk])], [wrap(data[pk])])
    return metric, metric.get()


@pytest.mark.parametrize("i", range(len(METRICS)),
                         ids=[str(m[0]) for m in METRICS])
def test_metric_matches_jax(i):
    name, kwargs, updates = METRICS[i]
    jm, want = _run(jmx, name, kwargs, updates, jmx.nd.array)
    for wrap in (lambda a: mx.nd.array(a, ctx=mx.cpu()), torch.from_numpy,
                 lambda a: a):
        tm, got = _run(mx, name, kwargs, updates, wrap)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=RTOL)
        assert tm.get_name_value() == pytest.approx(jm.get_name_value())
    assert type(tm).__name__ == type(jm).__name__
    tm.reset()
    assert np.isnan(np.asarray(tm.get()[1], dtype=float)).all()


def test_custom_metric_np_and_config_match_jax():
    def mean_abs(label, pred):
        return float(np.abs(label - pred).mean())

    data = _data(1)
    out = []
    for mxmod, wrap in ((jmx, jmx.nd.array),
                        (mx, lambda a: mx.nd.array(a, ctx=mx.cpu()))):
        m = mxmod.metric.np(mean_abs)
        m.update([wrap(data["reg"][:, 0])], [wrap(data["reg_pred"])])
        c = mxmod.metric.create(lambda l, p: (float((l == p).sum()),
                                              len(l)), name="hits")
        c.update([wrap(data["labels"])], [wrap(data["labels"])])
        out.append((m.get(), c.get(),
                    mxmod.metric.Accuracy(axis=1).get_config()))
    assert out[0][0][0] == out[1][0][0]
    np.testing.assert_allclose(out[1][0][1], out[0][0][1], rtol=RTOL)
    assert out[1][1] == out[0][1] == ("custom(hits)", 1.0)
    assert out[1][2] == out[0][2]
    with pytest.raises(mx.MXNetError, match="unknown metric"):
        mx.metric.create("nope")


def test_bfloat16_predictions_read_as_float32():
    data = _data(2)
    m = mx.metric.Accuracy()
    m.update([torch.from_numpy(data["labels"])],
             [torch.from_numpy(data["prob"]).to(torch.bfloat16)])
    j = jmx.metric.Accuracy()
    j.update([jmx.nd.array(data["labels"])],
             [jmx.nd.array(data["prob"]).astype("bfloat16")])
    assert m.get() == j.get()


def _speedometer_lines(mxmod, caplog, metric):
    caplog.clear()
    sp = mxmod.callback.Speedometer(batch_size=8, frequent=2)
    data = _data(3)
    for nbatch in range(7):
        if metric is not None:
            metric.update([data["labels"]], [data["prob"]])
        sp(mxmod.callback.BatchEndParam(epoch=1, nbatch=nbatch,
                                        eval_metric=metric))
    bar = mxmod.callback.ProgressBar(total=7, length=10)
    bar(mxmod.callback.BatchEndParam(epoch=1, nbatch=3, eval_metric=None))
    log = mxmod.callback.log_train_metric(period=2, auto_reset=True)
    if metric is not None:
        metric.update([data["labels"]], [data["prob"]])
    log(mxmod.callback.BatchEndParam(epoch=1, nbatch=4, eval_metric=metric))
    # the speed varies from run to run: compare the lines without it
    return [" ".join(w for w in r.getMessage().split()
                     if not w.replace(".", "").isdigit() or "=" in w)
            for r in caplog.records]


@pytest.mark.parametrize("with_metric", [True, False])
def test_speedometer_progress_bar_and_log_match_jax(caplog, with_metric):
    with caplog.at_level(logging.INFO):
        got = _speedometer_lines(
            mx, caplog, mx.metric.Accuracy() if with_metric else None)
        want = _speedometer_lines(
            jmx, caplog, jmx.metric.Accuracy() if with_metric else None)
    assert got == want and len(got) == 3 + 1 + int(with_metric)
    assert any("samples/sec" in line for line in got)


def test_callbacks_not_ported_yet_raise(caplog):
    """The Module API's checkpoint callbacks raise naming A13;
    ``TelemetryLogger`` logs the telemetry summary as the JAX package's
    does, at its period, tagged by epoch or batch."""
    with pytest.raises(mx.MXNetError, match="ROADMAP A13"):
        mx.callback.module_checkpoint(None, "prefix")
    with pytest.raises(mx.MXNetError, match="ROADMAP A13"):
        mx.callback.do_checkpoint("prefix")
    lines = {}
    for mod in (mx, jmx):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="telemetry"):
            cb = mod.callback.TelemetryLogger(period=2)
            for i in range(4):
                cb(i)
            cb(mod.callback.BatchEndParam(epoch=1, nbatch=7,
                                          eval_metric=None))
            cb(mod.callback.BatchEndParam(epoch=1, nbatch=8,
                                          eval_metric=None))
        lines[mod] = [r.getMessage().split("telemetry summary")[0]
                      for r in caplog.records if r.name == "telemetry"]
    assert lines[mx] == lines[jmx] == ["[Epoch 1] ", "[Epoch 3] ",
                                       "[Epoch 1] Batch [8] "]
