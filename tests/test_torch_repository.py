"""Port parity: ``ModelRepository`` of ``mxnet_tpu_torch.serving`` against
the JAX package's, on the CPU.

``tests/test_serving.py``'s repository cases (swap and rollback, a
corrupt load that never serves, version coherence under traffic, an
unknown model and unload, rollback without a standby) and
``tests/test_generation.py::test_repository_dispatches_decode_capable_
nets`` run through both packages, each case parametrised over the
package with the same scenario and asserts. Values: y = 0.1 * sum(x) +
bias, exact to 1e-5 in float32. A decode-capable net gets a
``GenerationEngine``, whose ``canary()`` the staged load runs; the port's
and the JAX package's greedy answers are equal token for token on the
same weights. ``*_on_cuda`` tests (the repository's swap with both kinds
of engine captured on the card) skip without one.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

PKGS = ("jax", "torch")


class _Pkg:
    def __init__(self, which):
        self.jax = which == "jax"
        self.mx = jmx if self.jax else mx
        self.serving = self.mx.serving
        self.kw = {} if self.jax else {"ctx": mx.cpu()}


def _vec_net(p, bias=0.0, feat=8, classes=4, ctx=None):
    """y = 0.1 * sum(x) + bias per class: versions told apart by bias."""
    kw = {"ctx": ctx} if ctx is not None else p.kw
    net = p.mx.gluon.nn.HybridSequential()
    net.add(p.mx.gluon.nn.Dense(classes, in_units=feat))
    net.initialize(**kw)
    net[0].weight.set_data(p.mx.nd.ones((classes, feat), **kw) * 0.1)
    net[0].bias.set_data(p.mx.nd.ones((classes,), **kw) * bias)
    return net


def _load(p, repo, name, net, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_wait_ms", 1.0)
    return repo.load(name, net, shapes=[(8,)], **p.kw, **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_repository_swap_and_rollback(pkg):
    p = _Pkg(pkg)
    repo = p.serving.ModelRepository(keep=1)
    try:
        x = np.ones((8,), np.float32)
        _load(p, repo, "clf", _vec_net(p, bias=0.0), version="v1")
        np.testing.assert_allclose(repo.predict("clf", x, timeout=10.0),
                                   0.8, atol=1e-5)
        e2 = _load(p, repo, "clf", _vec_net(p, bias=100.0), version="v2")
        assert repo.models()["clf"] == {"live": "v2", "standby": ["v1"]}
        np.testing.assert_allclose(repo.predict("clf", x, timeout=10.0),
                                   100.8, atol=1e-4)
        compiles_v1 = repo._models["clf"]["standby"][0].stats()["compiles"]
        restored = repo.rollback("clf")
        assert restored.version == "v1"
        np.testing.assert_allclose(repo.predict("clf", x, timeout=10.0),
                                   0.8, atol=1e-5)
        # rollback is a pointer flip + resume, never a recapture
        assert restored.stats()["compiles"] == compiles_v1
        assert repo.models()["clf"] == {"live": "v1", "standby": ["v2"]}
        assert e2.version == "v2"
        assert repo.live_version("clf") == "v1"
    finally:
        repo.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_repository_corrupt_load_never_serves(pkg):
    p = _Pkg(pkg)
    repo = p.serving.ModelRepository()
    try:
        x = np.ones((8,), np.float32)
        _load(p, repo, "clf", _vec_net(p, bias=0.0), version="v1")
        with pytest.raises(p.serving.StagedLoadError, match="keeps serving"):
            _load(p, repo, "clf", _vec_net(p, bias=float("nan")),
                  version="v2")
        # the canary's veto: v2 never became visible
        assert repo.models()["clf"] == {"live": "v1", "standby": []}
        np.testing.assert_allclose(repo.predict("clf", x, timeout=10.0),
                                   0.8, atol=1e-5)
        # a crashing factory is as invisible
        with pytest.raises(p.serving.StagedLoadError):
            repo.load("clf", lambda: 1 / 0, shapes=[(8,)])
        assert repo.models()["clf"]["live"] == "v1"
    finally:
        repo.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_repository_swap_version_coherence_under_traffic(pkg):
    """Continuous requests across a live swap: every request succeeds and
    is answered by exactly one coherent version (its result matches the
    version stamped on its future)."""
    p = _Pkg(pkg)
    repo = p.serving.ModelRepository(keep=1)
    expected = {"v1": 0.8, "v2": 100.8}
    stop = threading.Event()
    outcomes, errors = [], []

    def client():
        x = np.ones((8,), np.float32)
        while not stop.is_set():
            try:
                fut = repo.submit("clf", x)
                out = fut.result(timeout=10.0)
                outcomes.append((fut.version, float(out[0, 0])))
            except BaseException as e:  # no error is acceptable mid-swap
                errors.append(e)
                return

    try:
        _load(p, repo, "clf", _vec_net(p, bias=0.0), version="v1")
        t = threading.Thread(target=client)
        t.start()
        time.sleep(0.05)  # traffic flowing on v1
        _load(p, repo, "clf", _vec_net(p, bias=100.0), version="v2")
        time.sleep(0.05)  # traffic flowing on v2
        stop.set()
        t.join(timeout=30.0)
        assert not t.is_alive()
        assert not errors, f"requests failed across the swap: {errors!r}"
        versions = {v for v, _ in outcomes}
        assert versions <= {"v1", "v2"} and "v2" in versions
        for version, value in outcomes:
            assert abs(value - expected[version]) < 1e-3, (version, value)
    finally:
        stop.set()
        repo.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_repository_unknown_model_and_unload(pkg):
    p = _Pkg(pkg)
    repo = p.serving.ModelRepository()
    with pytest.raises(p.serving.ServingError, match="no live version"):
        repo.engine("ghost")
    _load(p, repo, "m", _vec_net(p))
    assert repo.stats("m")["model"] == "m"
    assert repo.models()["m"] == {"live": "v1", "standby": []}
    repo.unload("m")
    with pytest.raises(p.serving.ServingError):
        repo.predict("m", np.ones((8,), np.float32))
    repo.unload("m")  # idempotent
    repo.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_repository_rollback_without_standby(pkg):
    p = _Pkg(pkg)
    repo = p.serving.ModelRepository()
    try:
        _load(p, repo, "m", _vec_net(p))
        with pytest.raises(p.serving.ServingError, match="no standby"):
            repo.rollback("m")
    finally:
        repo.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_repository_keep_window_releases_old_versions(pkg):
    """``keep=1``: a third version releases the first (closed, no longer
    a standby), and the second stays as the standby."""
    p = _Pkg(pkg)
    repo = p.serving.ModelRepository(keep=1)
    try:
        e1 = _load(p, repo, "m", _vec_net(p, bias=1.0), version="v1")
        _load(p, repo, "m", _vec_net(p, bias=2.0), version="v2")
        _load(p, repo, "m", _vec_net(p, bias=3.0), version="v3")
        assert repo.models()["m"] == {"live": "v3", "standby": ["v2"]}
        with pytest.raises(p.serving.EngineClosed, match="released"):
            e1.resume()
    finally:
        repo.close()


# -- decode-capable nets -----------------------------------------------------

TINY = dict(vocab_size=32, num_layers=1, d_model=16, num_heads=2, max_seq=32,
            seed=0)
TINY_ENG = dict(slots=2, chunk=2, cache_blocks=24, cache_block_size=4)


def _tiny_pair():
    from mxnet_tpu_torch.serving import params_from_numpy

    jnet = jmx.serving.TransformerDecoderLM(**TINY)
    tree = {k: ([{n: np.asarray(a) for n, a in lyr.items()} for lyr in v]
                if k == "layers" else np.asarray(v))
            for k, v in jnet.params().items()}
    net = mx.serving.TransformerDecoderLM(
        **TINY, device="cpu", params=params_from_numpy(tree, "cpu"))
    return jnet, net


def test_repository_dispatches_decode_capable_nets():
    """``repo.load`` sees ``decode_step_fn`` and serves the net with a
    GenerationEngine behind the same repository surface, its canary run
    at the staged load; the port's greedy tokens equal the JAX
    package's."""
    jnet, net = _tiny_pair()
    got = {}
    for p, n, kw in ((_Pkg("jax"), jnet, {}),
                     (_Pkg("torch"), net, {"device": "cpu"})):
        repo = p.serving.ModelRepository()
        try:
            engine = repo.load("lm", n, [4], version="v1", **TINY_ENG, **kw)
            assert isinstance(engine, p.serving.GenerationEngine)
            st = repo.stats("lm")
            assert st["engine"] == "generation"
            assert st["requests_ok"] == 1  # the canary's generation
            toks = repo.predict("lm", np.array([1, 2, 3], np.int32),
                                max_new_tokens=4, timeout=60.0)
            assert len(toks) == 4
            assert repo.stats("lm")["requests_ok"] == 2
            got[p.jax] = toks.tolist()
        finally:
            repo.close()
    assert got[False] == got[True]


def test_generation_canary_passes_a_nan_head_as_the_reference_does():
    """The JAX package's generation canary checks only that the greedy ids
    are in the vocabulary, and the argmax of all-NaN logits is id 0: a
    net whose head is NaN goes live and answers zeros in both packages
    (ROADMAP C18, a fault of the reference the port reproduces)."""
    import jax.numpy as jnp

    jnet, net = _tiny_pair()
    jnet._params["head"] = jnp.full_like(jnet._params["head"], jnp.nan)
    net.params()["head"].fill_(float("nan"))
    for p, n, kw in ((_Pkg("jax"), jnet, {}),
                     (_Pkg("torch"), net, {"device": "cpu"})):
        repo = p.serving.ModelRepository()
        try:
            repo.load("lm", n, [4], **TINY_ENG, **kw)
            toks = repo.predict("lm", np.array([1, 2, 3], np.int32),
                                max_new_tokens=3, timeout=60.0)
            assert toks.tolist() == [0, 0, 0]
        finally:
            repo.close()


# -- on the card -------------------------------------------------------------

def test_repository_swaps_captured_engines_on_cuda():
    """v1 serves from its captured graph while v2 stages (captures in
    thread-local mode) under traffic; every answer matches its version's
    weights; rollback makes no capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mxnet_tpu_torch.ops import _kernels

    p = _Pkg("torch")
    gpu = {"ctx": mx.gpu(0)}
    repo = mx.serving.ModelRepository(keep=1)
    stop, outcomes, errors = threading.Event(), [], []

    def client():
        x = np.ones((8,), np.float32)
        while not stop.is_set():
            try:
                fut = repo.submit("clf", x)
                outcomes.append((fut.version,
                                 float(fut.result(timeout=30.0)[0, 0])))
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
                return

    try:
        repo.load("clf", _vec_net(p, 0.0, ctx=mx.gpu(0)), shapes=[(8,)],
                  version="v1", max_batch=2, max_wait_ms=0.5, **gpu)
        t = threading.Thread(target=client)
        t.start()
        time.sleep(0.1)
        repo.load("clf", _vec_net(p, 100.0, ctx=mx.gpu(0)), shapes=[(8,)],
                  version="v2", max_batch=2, max_wait_ms=0.5, **gpu)
        time.sleep(0.1)
        before = dict(_kernels.LAUNCHES)
        restored = repo.rollback("clf")
        assert restored.stats()["compiles"] == 1
        assert dict(_kernels.LAUNCHES) == before
        time.sleep(0.05)
        stop.set()
        t.join(timeout=30.0)
        assert not errors and {v for v, _ in outcomes} == {"v1", "v2"}
        for version, value in outcomes:
            assert abs(value - {"v1": 0.8, "v2": 100.8}[version]) < 1e-3
    finally:
        stop.set()
        repo.close()
