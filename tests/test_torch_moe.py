"""Mixture-of-experts: the port against the JAX package's
``parallel/moe.py``, in one process and in gloo worlds of 2 (ep 2) and 4
(ep 4) against the reference on its virtual CPU mesh.

This file is also the worker (``tests/torch_world.py``): ``python
tests/test_torch_moe.py --worker <scenario> <out_dir>`` imports neither
JAX nor the JAX package.

The same numpy weights go to both packages (``init_moe_params`` draws
import torch_threads  # noqa: F401  (a worker's share of the cores)
from each package's own generator). Tolerance 1e-5 (relative and
absolute, float32), forward and gradients:

- ``top1_routing``/``top2_routing`` on random, tied and congested logits
  (dispatch equal, combine and aux within 1e-5); ties go to the first
  expert in both;
- ``moe_apply`` on one device and with experts over ``ep``, out, aux and
  the gradients of ``sum(out**2) + 0.01 * aux`` (the gate's whole on every
  rank, each rank's experts');
- ``moe_apply_a2a`` with tokens over ``ep``, ``chunked``, ``serial`` and
  ``nocomm``, top-1 and top-2, against the reference's same mode: each
  rank's rows, the aux, the experts' gradients and the gate's summed over
  the ranks (each rank gets its tokens' part); ``serial`` and ``chunked``
  within 1e-5 of each other at ample capacity (the reference test's);
- ``MoEDense`` eager and hybridized, with gradients, and the ``_contrib_moe``
  operator through ``nd``, against the reference's; ``measure_moe_overlap``
  gives the reference's fields.
"""

import os
import sys
import time

import numpy as np
import pytest

import torch_world

SPAWN_TIMEOUT_S = 120
WORLDS = {"ep2": 2, "ep4": 4}
TOL = 1e-5
T, DM, H, E = 32, 8, 16, 8
#: moe_apply_a2a's runs: (router, comm, capacity factor): every mode at
#: ample capacity, and the chunked exchange where tokens drop
A2A = [(r, c, 8.0) for r in ("top1", "top2")
       for c in ("chunked", "serial", "nocomm")] + \
    [(r, "chunked", 1.0) for r in ("top1", "top2")]


def weights(seed=3, d=DM, h=H, e=E):
    rs = np.random.RandomState(seed)
    return {"gate": (rs.randn(d, e) / np.sqrt(d)).astype(np.float32),
            "w1": (rs.randn(e, d, h) / np.sqrt(d)).astype(np.float32),
            "w2": (rs.randn(e, h, d) / np.sqrt(h)).astype(np.float32)}


def tokens(seed=4):
    return np.random.RandomState(seed).randn(T, DM).astype(np.float32)


# ---------------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------------

def worker(scenario, out_dir):
    if scenario == "imports":
        torch_world.imports_only()
    import torch

    mx, rank = torch_world.join()
    ep = WORLDS[scenario]
    mesh = mx.parallel.make_mesh({"ep": ep})
    moe = mx.parallel.moe
    res = {}
    full = {k: torch.from_numpy(v) for k, v in weights().items()}
    x = torch.from_numpy(tokens())

    def grads_of(params, out, aux):
        loss = (out ** 2).sum() + 0.01 * aux
        return torch.autograd.grad(loss, [params[k] for k in
                                          ("gate", "w1", "w2")])

    # moe_apply: tokens replicated, experts over ep
    p = {k: v.clone().requires_grad_(True) for k, v in
         moe.shard_moe_params(full, mesh).items()}
    out, aux = moe.moe_apply(p, x, mesh=mesh, capacity_factor=1.0)
    res["apply:out"], res["apply:aux"] = out.detach().numpy(), float(aux)
    for k, g in zip(("gate", "w1", "w2"), grads_of(p, out, aux)):
        res[f"apply:d{k}"] = g.numpy()

    # moe_apply_a2a: tokens split over ep
    n = T // ep
    xl = x[rank * n:(rank + 1) * n]
    for router, comm, cf in A2A:
        tag = f"a2a:{router}:{comm}:{cf}"
        p = {k: v.clone().requires_grad_(True) for k, v in
             moe.shard_moe_params(full, mesh).items()}
        out, aux = moe.moe_apply_a2a(p, xl, mesh, router=router,
                                     capacity_factor=cf, chunks=2,
                                     comm=comm)
        res[f"{tag}:out"], res[f"{tag}:aux"] = out.detach().numpy(), \
            float(aux)
        for k, g in zip(("gate", "w1", "w2"), grads_of(p, out, aux)):
            res[f"{tag}:d{k}"] = g.numpy()
    with mx.cpu():
        rep = moe.measure_moe_overlap(mesh, d_model=8, d_hidden=16, steps=2,
                                      warmup=1)
    res["probe"] = str(rep)
    np.savez(os.path.join(out_dir, f"{scenario}_rank{rank}.npz"), **res)
    mx.kv.shutdown_distributed()


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def _jax_moe(jax, jnp, fn, params, *args, **kw):
    """``fn``'s out and aux, and ``jax.grad`` of ``sum(out**2) + 0.01 *
    aux`` for gate, w1 and w2."""
    def loss(p):
        out, aux = fn(p, *args, **kw)
        return jnp.sum(out ** 2) + 0.01 * aux, (out, aux)

    (_, (out, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return (np.asarray(out), float(aux),
            {k: np.asarray(v) for k, v in g.items()})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import mxnet_tpu as jmx
    from mxnet_tpu.parallel import moe as jmoe

    out_dir = str(tmp_path_factory.mktemp("moe"))
    started = {s: torch_world.start(__file__, s, n, out_dir)
               for s, n in WORLDS.items()}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    ref = {}
    params = {k: jnp.asarray(v) for k, v in weights().items()}
    x = jnp.asarray(tokens())
    for s, ep in WORLDS.items():
        mesh = jmx.parallel.make_mesh({"ep": ep}, devices=jax.devices()[:ep])
        ref[(s, "apply")] = _jax_moe(jax, jnp, jmoe.moe_apply, params, x,
                                     mesh=mesh, capacity_factor=1.0)
        for router, comm, cf in A2A:
            ref[(s, router, comm, cf)] = _jax_moe(
                jax, jnp, jmoe.moe_apply_a2a, params, x, mesh,
                router=router, capacity_factor=cf, chunks=2, comm=comm)
    logs = {s: torch_world.finish(p, deadline, SPAWN_TIMEOUT_S)
            for s, p in started.items()}
    return {"dir": out_dir, "logs": logs, "ref": ref}


def _ranks(worlds, scenario):
    return torch_world.results(worlds["dir"], scenario,
                               worlds["logs"][scenario])


def _close(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("scenario", sorted(WORLDS))
def test_moe_apply_over_ep_matches_reference(worlds, scenario):
    ep = WORLDS[scenario]
    out, aux, g = worlds["ref"][(scenario, "apply")]
    n = E // ep
    for r, res in enumerate(_ranks(worlds, scenario)):
        _close(res["apply:out"], out, "out")
        _close(res["apply:aux"], aux, "aux")
        _close(res["apply:dgate"], g["gate"], "gate")
        _close(res["apply:dw1"], g["w1"][r * n:(r + 1) * n], "w1")
        _close(res["apply:dw2"], g["w2"][r * n:(r + 1) * n], "w2")


@pytest.mark.parametrize("router,comm,cf", A2A)
@pytest.mark.parametrize("scenario", sorted(WORLDS))
def test_moe_apply_a2a_matches_reference(worlds, scenario, router, comm,
                                         cf):
    ep = WORLDS[scenario]
    out, aux, g = worlds["ref"][(scenario, router, comm, cf)]
    tag = f"a2a:{router}:{comm}:{cf}"
    ranks = _ranks(worlds, scenario)
    n, m = T // ep, E // ep
    for r, res in enumerate(ranks):
        _close(res[f"{tag}:out"], out[r * n:(r + 1) * n], f"{tag} out")
        _close(res[f"{tag}:aux"], aux, f"{tag} aux")
        _close(res[f"{tag}:dw1"], g["w1"][r * m:(r + 1) * m], f"{tag} w1")
        _close(res[f"{tag}:dw2"], g["w2"][r * m:(r + 1) * m], f"{tag} w2")
    _close(sum(res[f"{tag}:dgate"] for res in ranks), g["gate"],
           f"{tag} gate")
    if comm == "serial" and cf == 8.0:
        # the reference test's condition: ample capacity (chunked pads the
        # capacity to its chunk count, so a tight one drops differently)
        for res in ranks:
            _close(res[f"{tag}:out"],
                   res[f"a2a:{router}:chunked:{cf}:out"], "serial/chunked")


@pytest.mark.parametrize("scenario", sorted(WORLDS))
def test_measure_moe_overlap_probe(worlds, scenario):
    for res in _ranks(worlds, scenario):
        rep = eval(str(res["probe"]))
        assert set(rep) == {"exposed", "hidden_fraction", "step_seconds"}
        assert -1.0 <= rep["hidden_fraction"] <= 1.0
        assert rep["exposed"]["chunked"] >= 0.0
        assert rep["exposed"]["serial"] >= 0.0
        assert set(rep["step_seconds"]) == {"nocomm", "chunked", "serial"}


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def _logits():
    rs = np.random.RandomState(0)
    return {"random": rs.randn(12, 4).astype(np.float32),
            "ties": np.tile(np.array([[1.0, 3.0, 3.0, 0.5]], np.float32),
                            (12, 1)),
            "congested": np.tile(np.array([[4.0, 3.9, 0.0, 0.0]],
                                          np.float32), (12, 1))}


@pytest.mark.parametrize("capacity", [2, 3, 8])
@pytest.mark.parametrize("case", ["random", "ties", "congested"])
@pytest.mark.parametrize("router", ["top1_routing", "top2_routing"])
def test_routing_matches_reference(router, case, capacity):
    import jax.numpy as jnp
    import torch

    from mxnet_tpu.parallel import moe as jmoe

    import mxnet_tpu_torch as mx

    logits = _logits()[case]
    want = getattr(jmoe, router)(jnp.asarray(logits), 4, capacity)
    got = getattr(mx.parallel.moe, router)(torch.from_numpy(logits), 4,
                                           capacity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1].numpy(), np.asarray(want[1]), "combine")
    _close(float(got[2]), float(want[2]), "aux")


def test_moe_apply_one_device_matches_reference():
    import jax
    import jax.numpy as jnp
    import torch

    from mxnet_tpu.parallel import moe as jmoe

    import mxnet_tpu_torch as mx

    w = weights()
    for router in ("top1", "top2"):
        out, aux, g = _jax_moe(jax, jnp, jmoe.moe_apply,
                               {k: jnp.asarray(v) for k, v in w.items()},
                               jnp.asarray(tokens()), capacity_factor=1.0,
                               router=router)
        p = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in w.items()}
        tout, taux = mx.parallel.moe.moe_apply(
            p, torch.from_numpy(tokens()), capacity_factor=1.0,
            router=router)
        _close(tout.detach().numpy(), out, router)
        _close(float(taux.detach()), aux, router)
        ((tout ** 2).sum() + 0.01 * taux).backward()
        for k in ("gate", "w1", "w2"):
            _close(p[k].grad.numpy(), g[k], f"{router} {k}")


def test_capacity_drops_tokens():
    import torch

    import mxnet_tpu_torch as mx

    w = {k: torch.from_numpy(v) for k, v in weights(1, 8, 16, 2).items()}
    w["gate"][:, 0] = 10.0
    out, _ = mx.parallel.moe.moe_apply(w, torch.ones(16, 8),
                                       capacity_factor=0.5)
    assert int((out.abs().sum(dim=1) > 1e-9).sum()) == 4


def _moe_dense(m, kw):
    from importlib import import_module

    layer = import_module(m.__name__ + ".gluon.contrib.nn").MoEDense(
        units=8, hidden_units=16, num_experts=4, capacity_factor=4.0,
        prefix="moedense0_")
    layer.initialize(**kw)
    x = m.nd.array(np.random.RandomState(6).randn(2, 6, 8)
                   .astype(np.float32), **kw)
    layer(x)
    w = weights(7, 8, 16, 4)
    for name in ("gate", "w1", "w2"):
        getattr(layer, name).set_data(m.nd.array(w[name], **kw))
    return layer, x


@pytest.mark.parametrize("hybridize", [False, True])
def test_moe_dense_matches_reference(hybridize):
    import mxnet_tpu as jmx

    import mxnet_tpu_torch as mx

    outs = []
    for m, kw in ((jmx, {}), (mx, {"ctx": mx.cpu()})):
        layer, x = _moe_dense(m, kw)
        if hybridize:
            layer(x)
            layer.hybridize()
        with m.autograd.record():
            o, aux = layer(x)
            loss = (o ** 2).sum() + 0.01 * aux
        loss.backward()
        outs.append([np.array(o.asnumpy()), np.array(aux.asnumpy())] +
                    [np.array(getattr(layer, n).grad().asnumpy())
                     for n in ("gate", "w1", "w2")])
    for j, t in zip(*outs):
        _close(t, j)


def test_contrib_moe_operator_matches_reference():
    import mxnet_tpu as jmx

    import mxnet_tpu_torch as mx

    w = weights()
    got = mx.nd.moe(mx.nd.array(tokens(), ctx=mx.cpu()),
                    *(mx.nd.array(w[k], ctx=mx.cpu())
                      for k in ("gate", "w1", "w2")), capacity_factor=2.0)
    want = jmx.nd.moe(jmx.nd.array(tokens()),
                      *(jmx.nd.array(w[k]) for k in ("gate", "w1", "w2")),
                      capacity_factor=2.0)
    for t, j in zip(got, want):
        _close(t.asnumpy(), j.asnumpy())


if __name__ == "__main__" and len(sys.argv) >= 4 and \
        sys.argv[1] == "--worker":
    worker(sys.argv[2], sys.argv[3])
