"""Port parity: MobileNetV2 (``mobilenetv2_0.25``, 10 classes) trained on
the CPU through the Gluon loop, with and without
``optimize_for("tpu_fused_conv_bn")``, against the JAX package; and the
pass's refusal of the nets that join branches on channels.

Through ``optimize_for`` every 1x1 conv of MobileNetV2 runs the fused
conv + BN-statistics operator (36 of them). A bottleneck without a
shortcut ends in a BatchNorm whose output stays a pending apply (relu
off), which the next 1x1 conv takes into its prologue: 7 such calls per
forward. Where the next bottleneck adds a shortcut, that pending apply
is also read by ``+``, so its backward sums both uses.

What is compared, and why:
- the first step's float32 output and loss against the JAX package's
  float64 ones, plain and fused, within 1e-4 of the largest |value|;
- every fused call of that step (K4's and K5's plain versions on the
  CPU) against the JAX package's ``_fused_fwd_reference`` and
  ``_fused_bwd_reference`` on the same arrays, within 1e-5 of each
  output's largest |value|;
- two SGD steps in float64, plain and fused, against the JAX package's
  plain and fused nets in float64 (``jax.enable_x64``): the first step's
  output, loss and every gradient, the second step's loss, and every
  parameter and running statistic after both updates, within 1e-9 of
  its layer's largest |value| (1.5e-12 measured);
- the fused net against the plain net in float64 over the same two
  steps, the same quantities and the eval-mode output after them.
Whole-net float32 gradients are not compared across the packages:
MobileNetV2's RELU6 inputs lie densely around its bounds, and one lying
within the two sides' rounding of a BatchNorm (about 1e-6 absolute; the
fused form ``raw * s + t`` rounds otherwise than ``(x - mean) * inv``)
flips its mask. At batch 4 x 96 x 96 the port's fused gradients moved
by 2.5e-5 to 2.6e-1 of their layer's largest from its plain ones over
16 seeded batches (9 of them above 1e-3), while in float64 the two agree
to 1e-14 and each is within 7e-6 of float64 when no mask flips.
The float64 steps keep every quantity in float64: a one-hot loss (the
sparse form takes its logsumexp in float32 in both packages) and SGD
hyperparameters exact in float32 (the JAX package's fused update carries
its scalars as float32: at lr 0.005, momentum 0.9 and wd 4e-5 that alone
puts its float64 weights 1.4e-8 of a layer's largest from the port's
after one step).

The JAX nets are built once per module and run hybridized (one compile
per pass); the port's net takes their weights by name through
``gluon.utils.load_numpy``. Batch 4 at 96 x 96 (standardised images)
keeps the last stage at 3 x 3, so every BatchNorm sees at least 36
values; at 64 x 64 (16 values) the step is chaotic in both packages (the
JAX package's own gradients move by 7.9e-2 of their layer's largest when
its input moves by one rounding).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.utils import load_numpy
from mxnet_tpu_torch.ops.shape_ops import NHWC_INTERIOR

OUT_TOL = 1e-4
NAME, PREFIX = "mobilenetv2_0.25", "mnv2_"
# SGD with momentum and about MobileNetV2's weight decay (4e-5, Sandler et
# al. 2018, 6.1), each value exact in float32 (see above); a small lr
# keeps two steps on this batch of 4 out of chaos
SGD64 = {"learning_rate": 2.0 ** -8, "momentum": 0.875, "wd": 2.0 ** -15}
TOL64 = 1e-9
RS = np.random.RandomState(0)
X = RS.randn(4, 3, 96, 96).astype(np.float32)
LABELS = RS.randint(0, 10, (4,)).astype(np.float32)
ONEHOT = np.eye(10)[LABELS.astype(int)]
F64 = {"dtype": "float64"}
FUSED_CONVS, PROLOGUE_RELU_OFF = 36, 7


def _net(mxmod):
    return mxmod.gluon.model_zoo.vision.get_model(NAME, classes=10,
                                                  prefix=PREFIX)


def _np(a):
    """A host copy (the JAX package's CPU ``asnumpy`` may alias a buffer
    that a later fused update donates and overwrites)."""
    return np.array(a.asnumpy())


def _step(mxmod, call, net, ctx_kw):
    """One recorded (training-mode) step: the output, the per-sample loss
    and every trainable parameter's gradient. In float64 the loss takes
    one-hot labels, whose dense form keeps the logits' type."""
    f64 = ctx_kw.get("dtype") == "float64"
    sce = mxmod.gluon.loss.SoftmaxCrossEntropyLoss(sparse_label=not f64)
    with mxmod.autograd.record():
        out = call(mxmod.nd.array(X, **ctx_kw))
        loss = sce(out, mxmod.nd.array(ONEHOT if f64 else LABELS, **ctx_kw))
    loss.backward()
    grads = {k: _np(p.grad()) for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return _np(out), _np(loss), grads


def _values(net):
    return {k: _np(p.data()) for k, p in net.collect_params().items()}


def _train(mxmod, call, net, ctx_kw, evaluate=True):
    """Two SGD64 steps: the first step's output, loss and gradients, the
    second step's loss, every parameter after both updates and (if
    ``evaluate``) the eval-mode output with them."""
    first = _step(mxmod, call, net, ctx_kw)
    trainer = mxmod.gluon.Trainer(net.collect_params(), "sgd", dict(SGD64))
    trainer.step(len(X))
    second_loss = _step(mxmod, call, net, ctx_kw)[1]
    trainer.step(len(X))
    eval_out = _np(call(mxmod.nd.array(X, **ctx_kw))) if evaluate else None
    return first, second_loss, _values(net), eval_out


def _jax_net(weights):
    """The JAX package's net holding ``weights``; its shapes come from an
    eager float32 forward, outside any x64 scope (inside one every
    operator would compile anew)."""
    net = _net(jmx)
    net.initialize()
    net(jmx.nd.array(X[:1]))
    for k, p in net.collect_params().items():
        p.set_data(jmx.nd.array(weights[k]))
    return net


def _jax_call(net, fused):
    """``net`` hybridized (one compile per pass), or its ``optimize_for``
    adapter."""
    net.hybridize()
    return net.optimize_for(backend="tpu_fused_conv_bn") if fused else net


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's Xavier weights and each net's two float64 SGD
    steps."""
    import jax

    np.random.seed(0)  # the JAX package's initializers draw from numpy
    init = _net(jmx)
    init.initialize(init=jmx.initializer.Xavier())
    init(jmx.nd.array(X[:1]))
    runs = {"names": list(init.collect_params().keys()),
            "weights": _values(init)}
    for fused in (False, True):
        net = _jax_net(runs["weights"])
        with jax.enable_x64(True):
            net.cast("float64")
            runs["float64", fused] = _train(jmx, _jax_call(net, fused), net,
                                            F64, evaluate=False)
    return runs


def _port_net(weights, fused):
    net = _net(mx)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(X[:1], ctx=mx.cpu()))
    load_numpy(net.collect_params(), weights)
    return net, (net.optimize_for(backend="tpu_fused_conv_bn") if fused
                 else net)


@pytest.fixture(scope="module")
def port_runs64(jax_runs):
    """The port's two float64 SGD steps, plain and fused, on the JAX
    package's weights. Torch runs on one thread meanwhile: float64
    convolutions run ATen's own multi-threaded loops, which slow by orders
    of magnitude when other test processes hold the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {}
        for fused in (False, True):
            net, call = _port_net(jax_runs["weights"], fused)
            net.cast("float64")
            runs[fused] = _train(mx, call, net, dict(F64, ctx=mx.cpu()))
        return runs
    finally:
        torch.set_num_threads(threads)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _check_layers(got, want, tol, what):
    """Each array of ``got`` within ``tol`` of its layer's largest |value|
    in ``want`` (a layer: the names up to the last ``_``). A projection
    BN's beta before a 1x1 conv + BN has a zero gradient in exact
    arithmetic and stays 0 up to float noise, so it is judged against
    its gamma."""
    assert sorted(got) == sorted(want), what
    layer_max = {}
    for k, v in want.items():
        layer = k.rsplit("_", 1)[0]
        layer_max[layer] = max(layer_max.get(layer, 0.0), np.abs(v).max())
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (what, k)
        err = np.abs(got[k] - v).max()
        assert err <= tol * layer_max[k.rsplit("_", 1)[0]], (what, k, err)


class _CountPrologues:
    """Inside ``with``: counts the fused operator's calls with and without
    a prologue, and the prologue calls whose relu is off."""

    def __enter__(self):
        self.plain = self.prologue = self.relu_off = 0
        self._saved = (mx.nd._contrib_fused_matmul_stats,
                       mx.nd._contrib_fused_scaled_matmul_stats)
        plain, scaled = self._saved

        def count_plain(*args, **kw):
            self.plain += 1
            return plain(*args, **kw)

        def count_scaled(*args, relu=False, **kw):
            self.prologue += 1
            self.relu_off += not relu
            return scaled(*args, relu=relu, **kw)

        mx.nd._contrib_fused_matmul_stats = count_plain
        mx.nd._contrib_fused_scaled_matmul_stats = count_scaled
        return self

    def __exit__(self, *exc):
        (mx.nd._contrib_fused_matmul_stats,
         mx.nd._contrib_fused_scaled_matmul_stats) = self._saved
        return False


def test_param_names_equal_jax(jax_runs):
    assert list(_net(mx).collect_params().keys()) == jax_runs["names"]
    assert jax_runs["names"][-1] == f"{PREFIX}output_pred_weight"


def test_fused_pass_marks_every_1x1_conv(jax_runs):
    """36 fused convs (17 expansions, 17 projections, the 320 -> 1280 conv
    and the classifier); in one forward 29 take a plain input and 7 a
    pending apply with relu off."""
    net, call = _port_net(jax_runs["weights"], True)
    marked = []

    def walk(b):
        if getattr(b, "_tpu_fused", False):
            marked.append(b)
        for c in b._children.values():
            walk(c)

    walk(net)
    assert len(marked) == FUSED_CONVS
    with _CountPrologues() as n:
        _step(mx, call, net, {"ctx": mx.cpu()})
    assert n.plain + n.prologue == FUSED_CONVS
    assert n.prologue == n.relu_off == PROLOGUE_RELU_OFF


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_forward_and_loss_match_jax(jax_runs, fused):
    """The first step's output and loss (training mode) in float32,
    against the JAX package's net in float64 (its float32 net sits as far
    from that as the port's)."""
    net, call = _port_net(jax_runs["weights"], fused)
    out, loss, grads = _step(mx, call, net, {"ctx": mx.cpu()})
    jout, jloss = jax_runs["float64", fused][0][:2]
    assert _rel(out, jout) <= OUT_TOL
    assert _rel(loss, jloss) <= OUT_TOL
    assert all(np.isfinite(g).all() for g in grads.values())


def test_fused_calls_match_jax_reference(jax_runs):
    """Each of the 36 forward and 36 backward calls of the fused operator
    in one step, held against the JAX package's reference functions on
    the same arrays."""
    import jax

    from mxnet_tpu.ops import fused_conv_bn as J
    from mxnet_tpu_torch.ops import fused_conv_bn as fcbn

    # one compile per shape instead of one dispatch per operator
    ref_fwd = jax.jit(J._fused_fwd_reference, static_argnames=("relu",))
    ref_bwd = jax.jit(J._fused_bwd_reference, static_argnames=("relu",))

    def jarr(t):
        return None if t is None else jmx.nd.array(
            t.detach().numpy()).data

    def close(got, want, what, sums=()):
        """Each output within 1e-5 of its largest |value|; a column sum
        (``sums``: its index and the matrix it sums) within 1e-5 of the
        largest sum of |terms| (a sum of terms of both signs may cancel
        far below them)."""
        for i, (g, w) in enumerate(zip(got, want)):
            if w is None:
                assert g is None, what
                continue
            w = np.array(w)
            scale = np.abs(w).max()
            for j, terms in sums:
                if i == j:
                    scale = np.abs(terms).sum(axis=0).max()
            err = np.abs(g.detach().numpy() - w).max()
            assert err <= 1e-5 * max(scale, 1e-30), (what, i, err)

    calls = {"fwd": 0, "bwd": 0, "prologue_relu_off": 0}
    fwd, bwd = fcbn._fused_fwd, fcbn._fused_bwd

    def fwd_checked(x, w, scale, shift, relu):
        out = fwd(x, w, scale, shift, relu)
        want = ref_fwd(jarr(x), jarr(w), jarr(scale), jarr(shift),
                       relu=relu)
        y = np.array(want[0])
        close(out, want, "fwd", sums=((1, y), (2, y * y)))
        calls["fwd"] += 1
        calls["prologue_relu_off"] += scale is not None and not relu
        return out

    def bwd_checked(x, w, y, scale, shift, dy, dsum, dssq, relu):
        dx, dw, dsc, dbi = bwd(x, w, y, scale, shift, dy, dsum, dssq, relu)
        jdx, jdw, jdsc, jdbi = ref_bwd(
            *[jarr(t) for t in (x, w, y, scale, shift, dy, dsum, dssq)],
            relu=relu)
        # dscale and dbias sum dX's rows (times x): judged against the
        # sums of their terms' magnitudes
        dxa = np.array(jdx) / (1.0 if scale is None
                               else scale.detach().numpy())
        close((dx, dw, dsc, dbi), (jdx, jdw, jdsc, jdbi), "bwd",
              sums=((2, dxa * x.detach().numpy()), (3, dxa)))
        calls["bwd"] += 1
        return dx, dw, dsc, dbi

    net, call = _port_net(jax_runs["weights"], True)
    fcbn._fused_fwd, fcbn._fused_bwd = fwd_checked, bwd_checked
    try:
        _step(mx, call, net, {"ctx": mx.cpu()})
    finally:
        fcbn._fused_fwd, fcbn._fused_bwd = fwd, bwd
    assert calls == {"fwd": FUSED_CONVS, "bwd": FUSED_CONVS,
                     "prologue_relu_off": PROLOGUE_RELU_OFF}


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_train_steps_match_jax_in_float64(jax_runs, port_runs64, fused):
    """Two SGD steps in float64 against the JAX package's net in float64:
    the first step's output, loss and every gradient (the depthwise
    convs', RELU6's, each BatchNorm's and, fused, K4's and K5's plain
    versions), the second step's loss, every parameter and running
    statistic after both updates; the loss falls."""
    (out, loss, grads), loss2, values, _ = port_runs64[fused]
    (jout, jloss, jgrads), jloss2, jvalues, _ = jax_runs["float64", fused]
    assert out.dtype == jout.dtype == loss.dtype == np.float64
    assert loss2.mean() < loss.mean()
    for got, want in ((out, jout), (loss, jloss), (loss2, jloss2)):
        assert _rel(got, want) <= TOL64
    _check_layers(grads, jgrads, TOL64, "gradient")
    _check_layers(values, jvalues, TOL64, "value")


def test_fused_matches_plain_in_float64(port_runs64):
    """The fused net computes the plain net's function and gradient: in
    float64 (no mask flips), over two SGD steps, every gradient of the
    first step and every parameter and running statistic after the second
    within 1e-9 of its layer's largest |value|, and the eval-mode output
    with them."""
    (pfirst, ploss, pvals, peval), (ffirst, floss, fvals, feval) = \
        port_runs64[False], port_runs64[True]
    assert ffirst[0].dtype == feval.dtype == np.float64
    assert floss.mean() < ffirst[1].mean()
    for a, b in ((ffirst[0], pfirst[0]), (feval, peval),
                 (ffirst[1], pfirst[1]), (floss, ploss)):
        assert _rel(a, b) <= TOL64
    _check_layers(ffirst[2], pfirst[2], TOL64, "gradient")
    _check_layers(fvals, pvals, TOL64, "value")


def test_optimize_for_refuses_what_jax_refuses():
    """A net that joins branches on channels (DenseNet here; SqueezeNet's
    and Inception's in ``test_torch_zoo.py``) after a plain forward: the
    JAX package fails at the first fused forward (its NHWC interior joins
    on H), and so does the port, at the join (ROADMAP C7)."""
    x = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    jnet = jmx.gluon.model_zoo.vision.DenseNet(16, 8, [2, 2], classes=10)
    jnet.initialize()
    jnet.hybridize()  # one compile for the plain forward
    jnet(jmx.nd.array(x))
    call = jnet.optimize_for(backend="tpu_fused_conv_bn")
    jnet.hybridize()  # drop the plain graph
    with pytest.raises(Exception, match="[Cc]oncatenat"):
        call(jmx.nd.array(x))
    net = mx.gluon.model_zoo.vision.DenseNet(16, 8, [2, 2], classes=10)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(x, ctx=mx.cpu()))
    call = net.optimize_for(backend="tpu_fused_conv_bn")
    with pytest.raises(MXNetError, match="C7"):
        call(mx.nd.array(x, ctx=mx.cpu()))


class _JoinOnChannels(mx.gluon.HybridBlock):
    """A user's block: two 1x1 convs of equal width joined on ``dim``,
    then a global pool and a classifier (with equal widths a join on H
    succeeds, so nothing but the join itself can catch it)."""

    def __init__(self, dim, **kwargs):
        super().__init__(**kwargs)
        self._dim = dim
        with self.name_scope():
            self.a = mx.gluon.nn.Conv2D(4, 1)
            self.b = mx.gluon.nn.Conv2D(4, 1)
            self.pool = mx.gluon.nn.GlobalAvgPool2D()
            self.out = mx.gluon.nn.Dense(3)

    def hybrid_forward(self, F, x):
        y = F.concat(self.a(x), self.b(x), dim=self._dim)
        # a join of 2-D arrays on axis 1 is a join on features in both
        # layouts
        z = self.pool(y).reshape((0, -1))
        return self.out(F.concat(z, z, dim=1))


@pytest.mark.parametrize("first", ["plain_first", "fused_first"])
@pytest.mark.parametrize("dim", [1, -3])
def test_user_concat_on_channels_raises_in_fused_interior(first, dim):
    """Under ``optimize_for`` a join of 4-D arrays on axis 1 raises at the
    join, whether the net ran plain first or meets the pass before any
    forward (deferred shapes); the plain net runs, and a net that joins
    on another axis runs fused."""
    x = mx.nd.array(np.random.RandomState(5).randn(2, 4, 4, 4)
                    .astype(np.float32), ctx=mx.cpu())
    net = _JoinOnChannels(dim)
    net.initialize(ctx=mx.cpu())
    if first == "plain_first":
        assert net(x).shape == (2, 3)
    call = net.optimize_for(backend="tpu_fused_conv_bn")
    with pytest.raises(MXNetError, match="C7"):
        call(x)
    # the interior ends with the call, even a failed one
    assert NHWC_INTERIOR.get() is False
    plain = _JoinOnChannels(dim)
    plain.initialize(ctx=mx.cpu())
    assert plain(x).shape == (2, 3)
    joins_w = _JoinOnChannels(2)  # W in NCHW, H in NHWC: not refused
    joins_w.initialize(ctx=mx.cpu())
    assert joins_w.optimize_for(backend="tpu_fused_conv_bn")(x).shape \
        == (2, 3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# MobileNetV2 1.0's extremes at batch 128 (its widest M at its narrowest K
# and N, a stage-4 shape, the classifier) and mobilenetv2_0.75's 12
# channels (24 bytes a bf16 row) as N and as K
CUDA_SHAPES = {"m1605632_k32_n16": (1605632, 32, 16),
               "m1605632_k16_n96": (1605632, 16, 96),
               "m25088_k384_n96": (25088, 384, 96),
               "m128_k1280_n1000": (128, 1280, 1000),
               "m1605632_k24_n12": (1605632, 24, 12),
               "m1605632_k12_n72": (1605632, 12, 72)}
# kernel vs plain, relative to each output's largest |value|: fp32 differs
# by summation order only; bf16 and fp16 y, dx and dw round once on both
# sides (2^-7, 2^-10) while the statistics stay fp32 (chip_smoke's
# FUSED_TOL)
CUDA_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-4),
            "float16": (2.0 ** -10, 1e-4)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("mode", ["plain", "prologue", "prologue_relu"])
@pytest.mark.parametrize("shape", list(CUDA_SHAPES))
def test_fused_kernels_at_mobilenet_shapes_on_cuda(shape, mode, dtype):
    """K4 and K5's two kernels at MobileNet's shapes against their plain
    versions on the card (float16 cotangents scaled by 2^-6, as a loss
    scale would, so dW's long sums stay inside float16)."""
    import torch

    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.ops import fused_conv_bn as F

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    M, K, N = CUDA_SHAPES[shape]
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*size, scale=1.0):
        return torch.randn(size, generator=gen, device="cuda") * scale

    ct = 2.0 ** -6 if dt == torch.float16 else 1.0
    pro, relu = mode != "plain", mode == "prologue_relu"
    x, w = randn(M, K).to(dt), randn(K, N, scale=K ** -0.5).to(dt)
    s = torch.rand(K, generator=gen, device="cuda") + 0.5 if pro else None
    t = randn(K, scale=0.1) if pro else None
    dy = randn(M, N, scale=ct).to(dt)
    dsum, dssq = randn(N, scale=ct), randn(N, scale=0.01 * ct)
    n0 = dict(_kernels.LAUNCHES)
    got = F._cuda_fused_fwd(x, w, s, t, relu)
    want = F._torch_fused_fwd(x, w, s, t, relu)
    y = want[0]
    got_b = F._cuda_fused_dx(x, w, y, s, t, dy, dsum, dssq, relu) \
        + (F._cuda_fused_dw(x, w, y, s, t, dy, dsum, dssq, relu),)
    torch.cuda.synchronize()
    dx, dw, dsc, dbi = F._torch_fused_bwd(x, w, y, s, t, dy, dsum, dssq,
                                          relu)
    lim_t, lim_f = CUDA_TOL[dtype]
    for name, g, r, lim in (("y", got[0], want[0], lim_t),
                            ("ysum", got[1], want[1], lim_f),
                            ("yssq", got[2], want[2], lim_f),
                            ("dx", got_b[0], dx, lim_t),
                            ("dscale", got_b[1], dsc, lim_f),
                            ("dbias", got_b[2], dbi, lim_f),
                            ("dw", got_b[3], dw, lim_t)):
        if r is None:
            assert g is None, name
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, name
        err = float((g.float() - r.float()).abs().max())
        assert err <= lim * float(r.float().abs().max()), (name, err)
    for k in ("fused_fwd", "fused_dw", "fused_dx"):
        assert _kernels.LAUNCHES[k] == n0.get(k, 0) + 1


# MobileNet 1.0 at batch 128 x 224 x 224 through optimize_for, NVIDIA H100
# 80GB HBM3 at 700.00 W: (kernel run, fp32 plain K5 run, TF32 control run),
# each run's gradient distance to the run with K5 in float64 on the same
# forward, as the worst element against its own largest |grad| and as the
# worst layer's relative L2 distance (chip_smoke._layer_l2)
MOBILENET_WORST_ELEMENT = (2.830e-2, 9.074e-3, 1.411)
MOBILENET_WORST_LAYER_L2 = (1.907e-5, 1.274e-5, 1.300e-3)


def test_mobilenet_k5_gate_reads_layers():
    """At init MobileNet's single gradient elements are noise (the stem
    BatchNorm's beta moves 9.1e-3 between cuBLAS's fp32 and float64), so
    the worst-element gate tells nothing; in each layer's L2 norm the
    kernels are as close to float64 as fp32 and the TF32 control 68 times
    farther than the gate."""
    import chip_smoke

    passes, _ = chip_smoke.k5_grad_gate(*MOBILENET_WORST_LAYER_L2)
    assert passes
    passes, _ = chip_smoke.k5_grad_gate(*MOBILENET_WORST_ELEMENT)
    assert not passes


def test_layer_l2_groups_each_layer():
    """``_layer_l2`` pools a conv's weight and bias, a BatchNorm's gamma
    and beta: a beta whose own gradient is near zero counts against its
    gamma."""
    import torch

    import chip_smoke

    ref = {"n_conv0_weight": torch.tensor([3.0, 4.0]),
           "n_conv0_bias": torch.tensor([0.0]),
           "n_bn0_gamma": torch.tensor([1.0]),
           "n_bn0_beta": torch.tensor([1e-9])}
    got = dict(ref, n_bn0_beta=torch.tensor([1e-3]))
    worst, layer = chip_smoke._layer_l2(got, ref)
    assert layer == "n_bn0" and abs(worst - 1e-3) < 1e-9
    got = dict(ref, n_conv0_bias=torch.tensor([0.05]))
    worst, layer = chip_smoke._layer_l2(got, ref)
    assert layer == "n_conv0" and abs(worst - 0.01) < 1e-9
