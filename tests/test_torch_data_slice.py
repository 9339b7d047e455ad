"""The data slice as a whole, in both packages from the same weights
(carried by a ``.params`` file written by the JAX net and loaded by the
port's).

(a) ``examples/train_mnist_gluon.py``'s model and synthetic stand-in
(separable classes), cut to 512 images: ``ArrayDataset.transform`` ->
``DataLoader(batch_size=128)`` -> the hybridized MLP (Dense 256/128/10)
-> ``Trainer`` SGD lr 0.02, one epoch. Every step's mean loss agrees
within 1e-5 relative (float32 products in another order).

(b) A thumbnail ``resnet18_v1`` (10 classes) at 32 x 32, fed from
``mx.io.ImageRecordIter`` over a JPEG pack with random crops, mirrors and
ImageNet's mean and std (one pipeline thread: the same batches in both
packages), two SGD steps at lr 0.005. The first step's loss agrees within
1e-5 relative. The second within 1e-3: at 32 x 32 the last stages hold
4 x 4 or 8 x 8 maps, and the first step's gradients of some BatchNorm's
beta and of the conv before it differ by up to 2e-2 of their layer's
largest value while its gamma agrees within 1e-5 (measured on the CPU
over several initialisations): ReLU masks at BatchNorm outputs within
rounding of zero fall differently in the two packages (as in
``test_torch_mobilenet.py``), and the second loss moved by up to 2.3e-4.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


def _np(a):
    return np.array(a.asnumpy())


def _synthetic(n=512):
    rng = np.random.RandomState(0)
    imgs = (rng.rand(n, 28, 28, 1) * 255).astype(np.uint8)
    labels = rng.randint(0, 10, (n,)).astype(np.int32)
    for i in range(n):
        imgs[i, labels[i] * 2:labels[i] * 2 + 3] = 255
    return imgs, labels.astype(np.float32)


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(256, activation="relu"),
            pkg.gluon.nn.Dense(128, activation="relu"),
            pkg.gluon.nn.Dense(10))
    return net


def _train(pkg, net, batches, ctx, lr, opt_args=None):
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                dict({"learning_rate": lr}, **(opt_args or {})))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for data, label in batches:
        data = data.as_in_context(ctx)
        label = label.as_in_context(ctx)
        with pkg.autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
        trainer.step(data.shape[0])
        losses.append(float(_np(loss).mean()))
    return losses


def _carry(jnet, net, tmp_path, ctx):
    f = str(tmp_path / "w.params")
    jnet.save_parameters(f)
    net.load_parameters(f, ctx=ctx)


def test_mnist_mlp_epoch_matches_jax(tmp_path):
    imgs, labels = _synthetic()

    def loader(pkg, ctx):
        def tf(data, label):
            return (pkg.nd.array(data, ctx=ctx).astype("float32") / 255.0,
                    label)

        ds = pkg.gluon.data.ArrayDataset(
            pkg.nd.array(imgs, ctx=ctx, dtype="uint8"), labels)
        return pkg.gluon.data.DataLoader(ds.transform(tf), 128)

    def flat(pkg, ld):
        for data, label in ld:
            yield data.reshape((data.shape[0], -1)), label

    jnet = _mlp(jmx)
    jnet.initialize(init=jmx.initializer.Xavier())
    jnet(jmx.nd.zeros((1, 784)))
    jnet.hybridize()
    net = _mlp(mx)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.zeros((1, 784), ctx=mx.cpu()))
    _carry(jnet, net, tmp_path, mx.cpu())
    net.hybridize()
    want = _train(jmx, jnet, flat(jmx, loader(jmx, jmx.cpu())), jmx.cpu(),
                  0.02)
    got = _train(mx, net, flat(mx, loader(mx, mx.cpu())), mx.cpu(), 0.02)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_resnet18_thumbnail_from_image_record_iter_matches_jax(tmp_path):
    from mxnet_tpu import _native as jnative
    from mxnet_tpu_torch import recordio

    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    rng = np.random.RandomState(1)
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    yy, xx = np.mgrid[0:40, 0:40]
    for i in range(8):
        img = np.stack([(xx * (i + 1) * 3) % 256, (yy * 5 + i * 20) % 256,
                        ((xx + yy) * 2 + rng.randint(0, 40, (40, 40)))
                        % 256], -1).astype(np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(
            0, float(rng.randint(10)), i, 0), img, quality=95))
    w.close()
    kw = dict(path_imgrec=rec, data_shape=(3, 32, 32), batch_size=4,
              rand_crop=True, rand_mirror=True, mean_r=123.68,
              mean_g=116.28, mean_b=103.53, std_r=58.395, std_g=57.12,
              std_b=57.375, preprocess_threads=1, seed=2)

    def batches(pkg):
        for b in pkg.io.ImageRecordIter(**kw):
            yield b.data[0], b.label[0].reshape((-1,))

    jnet = jmx.gluon.model_zoo.vision.get_model("resnet18_v1", classes=10,
                                                thumbnail=True)
    jnet.initialize(init=jmx.initializer.Xavier())
    jnet(jmx.nd.zeros((1, 3, 32, 32)))
    net = mx.gluon.model_zoo.vision.get_model("resnet18_v1", classes=10,
                                              thumbnail=True)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.zeros((1, 3, 32, 32), ctx=mx.cpu()))
    _carry(jnet, net, tmp_path, mx.cpu())
    sgd = {"momentum": 0.9, "wd": 1e-4}
    want = _train(jmx, jnet, batches(jmx), jmx.cpu(), 0.005, sgd)
    got = _train(mx, net, batches(mx), mx.cpu(), 0.005, sgd)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
