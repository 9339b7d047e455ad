"""Port parity: ``autograd`` of ``mxnet_tpu_torch`` against the JAX
package's, on the CPU.

``tests/test_autograd.py``'s and ``tests/test_higher_order_grad.py``'s
cases run through both packages on the same numpy inputs (seed 0), and the
gradients must agree within 1e-5 relative and 1e-6 absolute (float32; the
same arithmetic on both sides, rounded in a different order at most).
Where the reference raises ``MXNetError`` the port must too.

C10: a slice-assign inside ``record()`` is recorded. At c00cefc the port
wrote it unrecorded and gave ``x.grad = [18, 60, 18, 18]`` and
``v.grad = [0]`` for the reference's ``[18, 0, 18, 18]`` and ``[40]``.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

KW = {"ctx": mx.cpu()}
RTOL, ATOL = 1e-5, 1e-6


def _arr(mod, a, **kw):
    return mod.nd.array(np.asarray(a, np.float32),
                        **(KW if mod is mx else {}), **kw)


def _same(fn, rtol=RTOL, atol=ATOL):
    """``fn(mod)`` returns a list of numpy arrays; both packages agree."""
    want, got = fn(jmx), fn(mx)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64),
                                   rtol=rtol, atol=atol)
    return got


def test_simple_chain_branches_head_gradient():
    def run(mod):
        ag = mod.autograd
        out = []
        x = _arr(mod, [1.0, 2.0, 3.0])
        x.attach_grad()
        with ag.record():
            y = x * x + 2 * x
        y.backward()
        out.append(x.grad.asnumpy())
        x = _arr(mod, [2.0])
        x.attach_grad()
        with ag.record():
            a = x * 3
            b = a * a + x
        b.backward()
        out.append(x.grad.asnumpy())
        x = _arr(mod, [1.0, 2.0])
        x.attach_grad()
        with ag.record():
            y = x * x
        y.backward(_arr(mod, [2.0, 0.5]))
        out.append(x.grad.asnumpy())
        return out

    got = _same(run)
    np.testing.assert_allclose(got[1], [37.0])


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req(req):
    def run(mod):
        x = _arr(mod, [1.0, 1.0])
        x.attach_grad(grad_req=req)
        for _ in range(3):
            with mod.autograd.record():
                y = 2 * x
            y.backward()
        return [x.grad.asnumpy()]

    _same(run)
    for mod in (jmx, mx):
        x = _arr(mod, [1.0])
        x.attach_grad(grad_req="null")
        assert x.grad is None


def test_detach_stop_gradient_pause():
    def run(mod):
        ag, out = mod.autograd, []
        x = _arr(mod, [2.0])
        x.attach_grad()
        with ag.record():
            y = x * x
            z = y.detach() * x
        z.backward()
        out.append(x.grad.asnumpy())
        with ag.record():
            y = mod.nd.stop_gradient(x * x) * x
        y.backward()
        out.append(x.grad.asnumpy())
        with ag.record():
            y = mod.nd.BlockGrad(x * x) * x + mod.nd.make_loss(x)
        y.backward()
        out.append(x.grad.asnumpy())
        x = _arr(mod, [1.0])
        x.attach_grad()
        with ag.record():
            y = x * 2
            with ag.pause():
                y * 3
            w = y + 1
        w.backward()
        out.append(x.grad.asnumpy())
        return out

    _same(run)


def test_state_setters_match_jax():
    def flags(mod):
        ag, out = mod.autograd, []
        out.append(ag.set_recording(True))
        out.append(ag.is_recording())
        out.append(ag.set_training(True))
        out.append(ag.is_training())
        out.append(ag.set_recording(False))
        out.append(ag.set_training(False))
        out.append((ag.is_recording(), ag.is_training()))
        with ag.record(train_mode=True):
            with ag.predict_mode():
                out.append((ag.is_recording(), ag.is_training()))
        with ag.train_mode():
            out.append((ag.is_recording(), ag.is_training()))
        return out

    assert flags(mx) == flags(jmx)


def test_is_tracked_and_mark_variables():
    def run(mod):
        ag = mod.autograd
        x, g = _arr(mod, [1.0, 2.0]), _arr(mod, [0.0, 0.0])
        z = _arr(mod, [3.0])
        out = [ag.is_tracked(x), ag.is_tracked(z)]
        ag.mark_variables([x], [g])
        with ag.record():
            y = (x * x).sum()
            out.append(ag.is_tracked(y))
        y.backward()
        out.append(x.grad is g)
        return out, g.asnumpy()

    (jflags, jg), (tflags, tg) = run(jmx), run(mx)
    assert jflags == tflags
    np.testing.assert_allclose(tg, jg)


def test_intermediate_attach_grad_and_grad_api():
    def run(mod):
        ag, out = mod.autograd, []
        x = _arr(mod, [3.0])
        x.attach_grad()
        with ag.record():
            y = x * x
            y.attach_grad()
            z = y * 2
        z.backward()
        out += [y.grad.asnumpy(), x.grad.asnumpy()]
        x = _arr(mod, [2.0, 3.0])
        x.attach_grad()
        with ag.record():
            y = (x * x).sum()
        out.append(ag.grad(y, [x])[0].asnumpy())
        with ag.record():
            y = (x ** 3).sum()
        out.append(ag.grad(y, x, head_grads=_arr(mod, 2.0)).asnumpy())
        return out

    got = _same(run)
    np.testing.assert_allclose(got[0], [2.0])


def test_multi_output_and_retain_graph():
    def run(mod):
        ag, out = mod.autograd, []
        x = _arr(mod, [[1.0, 2.0], [3.0, 4.0]])
        x.attach_grad()
        with ag.record():
            parts = mod.nd.split(x, num_outputs=2, axis=1)
            s = parts[0].sum() + (parts[1] * 2).sum()
        s.backward()
        out.append(x.grad.asnumpy())
        x = _arr(mod, [2.0])
        x.attach_grad()
        with ag.record():
            y = x * x
        y.backward(retain_graph=True)
        out.append(x.grad.asnumpy().copy())
        y.backward()
        out.append(x.grad.asnumpy())
        return out

    _same(run)
    # C25: a second backward through a freed graph raises MXNetError in
    # both packages (the port let torch's RuntimeError through)
    for mod in (jmx, mx):
        x = _arr(mod, [1.0, 2.0])
        x.attach_grad()
        with mod.autograd.record():
            y = x * 2
        y.backward()
        with pytest.raises(mod.MXNetError):
            y.backward()


def test_custom_function():
    def run(mod):
        class Sigmoid(mod.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + mod.nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y)

        x = _arr(mod, [0.5, -1.0])
        x.attach_grad()
        with mod.autograd.record():
            y = Sigmoid()(x)
            z = (y * _arr(mod, [3.0, 5.0])).sum()
        z.backward()
        return [y.asnumpy(), x.grad.asnumpy()]

    _same(run)


def test_backward_through_mutation_snapshot_c9():
    """C9: a leaf mutated after recording keeps the value the tape saw
    (at c00cefc the port raised: ``x`` had become a new handle)."""
    def run(mod):
        x = _arr(mod, [2.0])
        x.attach_grad()
        with mod.autograd.record():
            y = x * x
        x *= 10
        y.backward()
        return [x.grad.asnumpy(), x.asnumpy()]

    got = _same(run)
    np.testing.assert_allclose(got[0], [4.0])


def test_setitem_gradient_flow_c10():
    def run(mod):
        x = mod.nd.ones((4,), **(KW if mod is mx else {}))
        x.attach_grad()
        v = _arr(mod, [5.0])
        v.attach_grad()
        with mod.autograd.record():
            y = x * 3
            y[1:2] = v * 2
            s = (y * y).sum()
        s.backward()
        return [x.grad.asnumpy(), v.grad.asnumpy(), y.asnumpy()]

    got = _same(run)
    np.testing.assert_allclose(got[0], [18, 0, 18, 18])
    np.testing.assert_allclose(got[1], [40.0])


@pytest.mark.parametrize("req", ["write", "add"])
def test_setitem_on_leaf_zeroes_overwritten_grad(req):
    def run(mod):
        a = mod.nd.ones((4,), **(KW if mod is mx else {}))
        a.attach_grad(grad_req=req)
        v = _arr(mod, [5.0])
        v.attach_grad()
        with mod.autograd.record():
            a[1:2] = v
            s = (a * a).sum()
        s.backward()
        return [a.grad.asnumpy(), v.grad.asnumpy()]

    got = _same(run)
    np.testing.assert_allclose(got[0], [2, 0, 2, 2])
    np.testing.assert_allclose(got[1], [10.0])


def test_setitem_preserves_pre_mutation_consumers():
    def run(mod):
        a = mod.nd.ones((4,), **(KW if mod is mx else {}))
        a.attach_grad()
        with mod.autograd.record():
            b = (a * 2).sum()
            a[1:2] = 5.0
        b.backward()
        return [a.grad.asnumpy(), a.asnumpy()]

    _same(run)


def test_inplace_inside_record_is_recorded():
    """``+=`` on a tracked array inside ``record()``: later consumers see
    the new value, earlier ones keep theirs. x = [1, 2], y = 3x,
    p = sum(y^2), y += x, q = sum(y^2): ds/dx = 18x + 32x = 50x. The JAX
    package gives 42x: its ``_iop`` rebinds the value but keeps y's tape
    identity at the old node, so q's gradient reaches x through y = 3x
    (ROADMAP C12, a fault of the reference); the port differentiates the
    value it computes."""
    def run(mod):
        x = _arr(mod, [1.0, 2.0])
        x.attach_grad()
        with mod.autograd.record():
            y = x * 3
            p = (y * y).sum()
            y += x
            q = (y * y).sum()
            s = p + q
        s.backward()
        return x.grad.asnumpy(), y.asnumpy()

    (jg, jy), (tg, ty) = run(jmx), run(mx)
    np.testing.assert_allclose(ty, jy)
    np.testing.assert_allclose(tg, [50.0, 100.0], rtol=RTOL)
    np.testing.assert_allclose(jg, [42.0, 84.0], rtol=RTOL)


def test_setitem_outside_record_unchanged():
    for mod in (jmx, mx):
        x = mod.nd.zeros((3,), **(KW if mod is mx else {}))
        x[1] = 7.0
        np.testing.assert_allclose(x.asnumpy(), [0, 7, 0])


def test_get_symbol_raises_naming_a13():
    with pytest.raises(mx.MXNetError, match="A13"):
        mx.autograd.get_symbol(mx.nd.ones((2,), **KW))


# ---------------------------------------------------------------------------
# higher order (test_higher_order_grad.py)
# ---------------------------------------------------------------------------

RS = np.random.RandomState(0)
UNARY = {
    "sin": RS.uniform(-2, 2, (3, 4)), "cos": RS.uniform(-2, 2, (5,)),
    "exp": RS.uniform(-1, 1, (4,)), "log": RS.uniform(0.5, 3, (6,)),
    "sigmoid": RS.uniform(-2, 2, (4,)), "relu": RS.uniform(-2, 2, (8,)),
    "tanh": RS.uniform(-2, 2, (5,)),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_second_order_unary(name):
    def run(mod):
        x = _arr(mod, UNARY[name])
        x.attach_grad()
        with mod.autograd.record():
            y = getattr(mod.nd, name)(x)
            gx = mod.autograd.grad(y, x, create_graph=True,
                                   retain_graph=True)
        gx.backward()
        return [x.grad.asnumpy()]

    _same(run)


def test_polynomial_third_order_and_head_grads():
    def run(mod):
        out = []
        x = _arr(mod, [0.5, 1.5, -2.0])
        x.attach_grad()
        with mod.autograd.record():
            y = x ** 4
            g1 = mod.autograd.grad(y, x, create_graph=True,
                                   retain_graph=True)
            g2 = mod.autograd.grad(g1, x, create_graph=True,
                                   retain_graph=True)
        g2.backward()
        out.append(x.grad.asnumpy())
        x = _arr(mod, [1.0, 2.0])
        x.attach_grad()
        w = _arr(mod, [3.0, 5.0])
        with mod.autograd.record():
            y = x ** 3
            gx = mod.autograd.grad(y, x, head_grads=w, create_graph=True,
                                   retain_graph=True)
        gx.backward()
        out.append(x.grad.asnumpy())
        return out

    got = _same(run)
    np.testing.assert_allclose(got[0], 24 * np.array([0.5, 1.5, -2.0]),
                               rtol=1e-5)


def test_two_variables_second_order():
    a_np = RS.rand(3, 4)
    b_np = RS.rand(4, 2)

    def run(mod):
        a, b = _arr(mod, a_np), _arr(mod, b_np)
        a.attach_grad()
        b.attach_grad()
        with mod.autograd.record():
            z = (mod.nd.dot(a, b) ** 2).sum()
            ga, gb = mod.autograd.grad(z, [a, b], create_graph=True,
                                       retain_graph=True)
            s = (ga * ga).sum() + (gb * ga.sum()).sum()
        s.backward()
        return [a.grad.asnumpy(), b.grad.asnumpy()]

    _same(run, rtol=1e-4, atol=1e-5)


def _dense_second_order(mod, hybridize, x_np, w_np, b_np):
    net = mod.gluon.nn.Dense(4, in_units=3)
    net.initialize(**(KW if mod is mx else {}))
    net.weight.set_data(_arr(mod, w_np))
    net.bias.set_data(_arr(mod, b_np))
    if hybridize:
        net.hybridize()
    x = _arr(mod, x_np)
    x.attach_grad()
    net(x)
    with mod.autograd.record():
        y = mod.nd.tanh(net(x)).sum()
        gx = mod.autograd.grad(y, x, create_graph=True, retain_graph=True)
        s = (gx * gx).sum()
    s.backward()
    return [x.grad.asnumpy()]


@pytest.mark.parametrize("hybridize", [False, True])
def test_create_graph_through_block(hybridize):
    """Second order through a Dense + tanh, eager and hybridized (the
    cached graph's backward recomputes its forward under create_graph)."""
    x_np, w_np, b_np = RS.rand(2, 3), RS.randn(4, 3), RS.randn(4)
    _same(lambda mod: _dense_second_order(mod, hybridize, x_np, w_np, b_np),
          rtol=1e-4, atol=1e-5)


def test_create_graph_through_flash_attention():
    """The port's attention Function under create_graph differentiates a
    recompute of its plain forward (no kernel runs): q's second-order
    gradient equals the JAX package's, and k's equals ``jax.grad`` twice
    through plain attention. The JAX package leaves k's buffer untouched:
    its grad node takes only the variables of ``grad()`` as inputs and
    holds everything else constant (ROADMAP C13)."""
    import jax
    import jax.numpy as jnp

    q_np, k_np, v_np = (RS.randn(1, 2, 8, 4).astype(np.float32)
                        for _ in range(3))

    def run(mod):
        q, k, v = _arr(mod, q_np), _arr(mod, k_np), _arr(mod, v_np)
        q.attach_grad()
        k.attach_grad()
        with mod.autograd.record():
            o = mod.nd.flash_attention(q, k, v, causal=True)
            g = mod.autograd.grad((o * o).sum(), q, create_graph=True,
                                  retain_graph=True)
            s = (g * g).sum()
        s.backward()
        return q.grad.asnumpy(), k.grad.asnumpy()

    def att(q, k):
        s = jnp.einsum("bhtd,bhsd->bhts", q, k) / 2.0
        s = jnp.where(jnp.tril(jnp.ones((8, 8), bool)), s, -1e30)
        return jnp.einsum("bhts,bhsd->bhtd", jax.nn.softmax(s, -1), v_np)

    def outer(q, k):
        g = jax.grad(lambda qq: (att(qq, k) ** 2).sum())(q)
        return (g * g).sum()

    (jq, jk), (tq, tk) = run(jmx), run(mx)
    _, ek = jax.grad(outer, argnums=(0, 1))(q_np, k_np)
    scale = float(np.abs(ek).max())
    np.testing.assert_allclose(tq, jq, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(tk, np.asarray(ek), rtol=1e-4,
                               atol=1e-5 * scale)
    assert not np.any(jk)


def test_create_graph_refusals_match_jax():
    for mod in (jmx, mx):
        err = mod.base.MXNetError
        x = _arr(mod, [1.0, 2.0])
        x.attach_grad()
        with mod.autograd.record():
            y = x ** 2
        with pytest.raises(err):  # outside record()
            mod.autograd.grad(y, x, create_graph=True, retain_graph=True)
        x = _arr(mod, [2.0])
        x.attach_grad()
        with mod.autograd.record():
            y = x * x
            x += 1
            z = y + x
            with pytest.raises(err):  # a variable mutated on the tape
                mod.autograd.grad(z, x, create_graph=True, retain_graph=True)
        x = _arr(mod, [1.0])
        x.attach_grad()
        z = _arr(mod, [2.0])
        with mod.autograd.record():
            y = x * 2
            with pytest.raises(err):  # a variable not on the tape
                mod.autograd.grad(y, z, create_graph=True, retain_graph=True)

        class Square(mod.autograd.Function):
            def forward(self, x):
                return x * x

            def backward(self, dy):
                return 2 * dy

        x = _arr(mod, [1.0, 2.0])
        x.attach_grad()
        with mod.autograd.record():
            y = Square()(x)
            with pytest.raises(err):  # through a custom Function
                mod.autograd.grad(y, x, create_graph=True, retain_graph=True)


def test_create_graph_through_hybridized_dropout_raises():
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(3, in_units=3), mx.gluon.nn.Dropout(0.5))
    net.initialize(**KW)
    net.hybridize()
    x = _arr(mx, RS.rand(2, 3))
    x.attach_grad()
    with mx.autograd.record():
        y = net(x).sum()
        with pytest.raises(mx.MXNetError, match="random"):
            mx.autograd.grad(y, x, create_graph=True, retain_graph=True)


def test_create_graph_through_the_flash_kernels_on_cuda():
    """On the card the attention Function's backward under create_graph
    differentiates the plain forward recomputed (no kernel), so the
    second-order gradients equal the host's plain float64 ones."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q_np, k_np, v_np = (RS.randn(2, 4, 64, 32) for _ in range(3))
    got = []
    for ctx, dtype in ((mx.gpu(0), "float32"), (mx.cpu(), "float64")):
        q, k, v = (mx.nd.array(a, ctx=ctx, dtype=dtype)
                   for a in (q_np, k_np, v_np))
        q.attach_grad()
        k.attach_grad()
        with mx.autograd.record():
            o = mx.nd.flash_attention(q, k, v, causal=True)
            g = mx.autograd.grad((o * o).sum(), q, create_graph=True,
                                 retain_graph=True)
            s = (g * g).sum()
        s.backward()
        got.append((q.grad.asnumpy(), k.grad.asnumpy()))
    for a, b in zip(*got):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


def test_abs_gradient_at_zero():
    """C24: ``abs``'s gradient is +1 at 0, the reference's (JAX's) rule;
    torch's ``sign`` gives 0 there. Exact."""
    def run(mod):
        x = _arr(mod, [1.0, 2.0, 3.0])
        x.attach_grad()
        with mod.autograd.record():
            y = mod.nd.abs(x - 2).sum()
        y.backward()
        return [x.grad.asnumpy()]

    got = _same(run, rtol=0, atol=0)
    np.testing.assert_array_equal(got[0], [-1.0, 1.0, 1.0])
