"""Ring attention: the port in gloo worlds of 2 (sp 2) and 4 (sp 4)
against the JAX package's ``ring_attention`` on its virtual CPU mesh.

This file is also the worker: ``python tests/test_torch_ring.py --worker
<scenario> <out_dir>`` (``tests/torch_world.py``) joins the world, runs
the scenario and writes ``<scenario>_rank<r>.npz``; it imports neither
JAX nor the JAX package. A module fixture starts both worlds at once,
each under a hard limit (``SPAWN_TIMEOUT_S``), and meanwhile computes the
reference's results in the test process.

Inputs: the reference test's shape (B 2, H 2, T 16, D 8), q, k and v from
numpy seed 0 scaled by 0.5, an upstream gradient from seed 1. Each rank
holds its 16/n positions; causal and not, the forward and ``jax.grad``
of ``sum(out * w)`` (the reference's gradient is JAX's transpose of its
scan and ``ppermute``; the port's is its hand-written ring backward,
which at sp 4 and causal sees more than one block a rank). Tolerance:
the reference test's, rtol 1e-4 and atol 1e-5. ``global_view=True``
gives the global result on every rank.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import os
import sys
import time

import numpy as np
import pytest

import torch_world

SPAWN_TIMEOUT_S = 120
SHAPE = (2, 2, 16, 8)
RTOL, ATOL = 1e-4, 1e-5
WORLDS = {"sp2": 2, "sp4": 4}


def inputs():
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(*SHAPE).astype(np.float32) * 0.5 for _ in range(3))
    w = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    return q, k, v, w


# ---------------------------------------------------------------------------
# the worker side
# ---------------------------------------------------------------------------

def worker(scenario, out_dir):
    if scenario == "imports":
        torch_world.imports_only()
    import torch

    mx, rank = torch_world.join()
    n = WORLDS[scenario]
    mesh = mx.parallel.make_mesh({"sp": n})
    q, k, v, w = (torch.from_numpy(a) for a in inputs())
    res = {}
    for causal in (False, True):
        tag = "causal" if causal else "full"
        local = [mx.parallel.shard_sequence(t, mesh).clone()
                 .requires_grad_(True) for t in (q, k, v)]
        out = mx.parallel.ring_attention(*local, mesh, causal=causal)
        (out * mx.parallel.shard_sequence(w, mesh)).sum().backward()
        res[f"{tag}:out"] = out.detach().numpy()
        for name, t in zip("qkv", local):
            res[f"{tag}:d{name}"] = t.grad.numpy()
    # the reference's form: global arrays in, the global result out
    glob = mx.parallel.ring_attention(q, k, v, mesh, causal=True,
                                      global_view=True)
    res["global:out"] = glob.numpy()
    # NDArrays on the tape
    qa, ka, va = (mx.nd.array(mx.parallel.shard_sequence(t, mesh).numpy(),
                              ctx=mx.cpu()) for t in (q, k, v))
    qa.attach_grad()
    with mx.autograd.record():
        o = mx.parallel.ring_attention(qa, ka, va, mesh)
    o.backward()
    res["nd:out"], res["nd:dq"] = o.asnumpy(), qa.grad.asnumpy()
    np.savez(os.path.join(out_dir, f"{scenario}_rank{rank}.npz"), **res)
    mx.kv.shutdown_distributed()


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import mxnet_tpu as jmx

    out_dir = str(tmp_path_factory.mktemp("ring"))
    started = {s: torch_world.start(__file__, s, n, out_dir)
               for s, n in WORLDS.items()}
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    q, k, v, w = (jnp.asarray(a) for a in inputs())
    ref = {}
    for s, n in WORLDS.items():
        mesh = jmx.parallel.make_mesh({"sp": n}, devices=jax.devices()[:n])
        for causal in (False, True):
            tag = "causal" if causal else "full"

            def loss(q, k, v, causal=causal, mesh=mesh):
                out = jmx.parallel.ring_attention(q, k, v, mesh,
                                                  causal=causal)
                return jnp.sum(out * w), out

            (_, out), grads = jax.jit(jax.value_and_grad(
                loss, (0, 1, 2), has_aux=True))(q, k, v)
            ref[(s, tag)] = [np.asarray(out)] + [np.asarray(g)
                                                 for g in grads]
    logs = {s: torch_world.finish(p, deadline, SPAWN_TIMEOUT_S)
            for s, p in started.items()}
    return {"dir": out_dir, "logs": logs, "ref": ref}


def _ranks(worlds, scenario):
    return torch_world.results(worlds["dir"], scenario,
                               worlds["logs"][scenario])


def _shard(a, r, n):
    m = a.shape[2] // n
    return a[:, :, r * m:(r + 1) * m]


@pytest.mark.parametrize("causal", ["full", "causal"])
@pytest.mark.parametrize("scenario", sorted(WORLDS))
def test_ring_attention_matches_reference(worlds, scenario, causal):
    n = WORLDS[scenario]
    out, dq, dk, dv = worlds["ref"][(scenario, causal)]
    for r, res in enumerate(_ranks(worlds, scenario)):
        for what, want in (("out", out), ("dq", dq), ("dk", dk),
                           ("dv", dv)):
            np.testing.assert_allclose(
                res[f"{causal}:{what}"], _shard(want, r, n), rtol=RTOL,
                atol=ATOL, err_msg=f"{scenario} rank {r} {causal} {what}")


@pytest.mark.parametrize("scenario", sorted(WORLDS))
def test_global_view_and_ndarray(worlds, scenario):
    n = WORLDS[scenario]
    out_c = worlds["ref"][(scenario, "causal")][0]
    out_f = worlds["ref"][(scenario, "full")][0]
    q, k, v, _ = inputs()
    for r, res in enumerate(_ranks(worlds, scenario)):
        np.testing.assert_allclose(res["global:out"], out_c, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(res["nd:out"], _shard(out_f, r, n),
                                   rtol=RTOL, atol=ATOL)
        assert res["nd:dq"].shape == _shard(q, r, n).shape
        assert np.isfinite(res["nd:dq"]).all()


if __name__ == "__main__" and len(sys.argv) >= 4 and \
        sys.argv[1] == "--worker":
    worker(sys.argv[2], sys.argv[3])
