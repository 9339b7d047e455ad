"""The PyTorch port stands alone: no file of ``mxnet_tpu_torch/`` and not
``chip_smoke.py`` imports JAX or any module of the JAX package
``mxnet_tpu`` (matched by exact top-level name, so ``mxnet_tpu_torch``
itself is allowed); importing the port's serving and training surfaces
loads no JAX, nor does the worker entry of ``tests/test_torch_dist.py``;
and without a CUDA card the entry points refuse to run
unless the CPU was asked for.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mxnet_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "mxnet_tpu"}


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scanner_matches_exact_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import mxnet_tpu_torch\nfrom mxnet_tpu.base import x\n"
                     "import jax.numpy as jnp\nfrom . import jax\n")
    assert [n for n, _ in _imported_roots(str(probe))] == [
        "mxnet_tpu_torch", "mxnet_tpu", "jax"]


def test_import_loads_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import mxnet_tpu_torch as mx; mx.serving.GenerationEngine; "
            "mx.gluon.Trainer; mx.models.bert_base; mx.nd.array; "
            "mx.gluon.model_zoo.vision.resnet50_v1; mx.nd.Convolution; "
            "mx.nd._contrib_fused_matmul_stats; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_dist_worker_entry_loads_no_jax(tmp_path):
    """``tests/test_torch_dist.py`` is also the worker of its worlds: run
    as ``--worker``, it imports the port, the kvstore's dist module and
    ``chip_smoke`` (its loss) and no JAX and no ``mxnet_tpu``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "test_torch_dist.py"),
         "--worker", "imports", str(tmp_path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]"


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import PagedKVCache, TransformerDecoderLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        TransformerDecoderLM()
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        PagedKVCache(1, 1, 4, max_seq=8)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.resolve_device("cuda:0")
    assert mx.resolve_device("cpu") == torch.device("cpu")
    assert mx.gpu(1) == torch.device("cuda", 1)
    net = TransformerDecoderLM(device="cpu")
    assert net.params()["embed"].device.type == "cpu"

    # training surface: the default context is the card
    assert mx.current_context() == mx.gpu(0) == mx.tpu(0)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.nd.array([1.0, 2.0])
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.nd.zeros((2,))
    dense = mx.gluon.nn.Dense(3, in_units=2)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        dense.initialize()
    bert = mx.models.get_bert_model(
        vocab_size=16, num_layers=1, units=8, hidden_size=16, num_heads=2,
        max_length=8, dropout=0.0, use_pooler=False, use_classifier=False)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        bert.initialize()
    resnet = mx.gluon.model_zoo.vision.resnet50_v1()
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        resnet.initialize()
    assert mx.nd.array([1.0, 2.0], ctx=mx.cpu()).context == mx.cpu()
    dense.initialize(ctx=mx.cpu())
    assert dense.weight.data().data.device.type == "cpu"
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        assert mx.nd.ones((2,)).context == mx.cpu()
    assert mx.current_context() == mx.gpu(0)


# the modules of the fifteenth slice (the registry, dispatch, engine,
# random, test_utils and the nd namespaces generated from the registry)
NEW_MODULES = ("ops/registry.py", "ops/dispatch.py", "engine.py",
               "random.py", "ndarray/random.py", "ndarray/_internal.py",
               "test_utils.py")


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_new_modules_are_scanned(rel):
    path = os.path.join(PKG, rel)
    assert path in _port_files()
    assert not [n for n, _ in _imported_roots(path) if n in FORBIDDEN]


def test_random_and_engine_entry_points_need_cuda_or_explicit_cpu(
        monkeypatch):
    import mxnet_tpu_torch as mx

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.nd.random.uniform(shape=(2,))
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.nd.arange(3)
    assert mx.nd.random.uniform(shape=(2,), ctx=mx.cpu()).shape == (2,)
    assert mx.num_gpus() == 0
    mx.engine.waitall()


# the modules of single-process serving (the engine, its batcher, the
# repository, the batch-shape guard) and the serving comparison script
SERVING_MODULES = ("gluon/data/__init__.py", "gluon/data/shape_guard.py",
                   "serving/batcher.py", "serving/engine.py",
                   "serving/repository.py", "serving/_histogram.py")


@pytest.mark.parametrize("rel", SERVING_MODULES + ("../tools/serve_ab.py",))
def test_serving_modules_are_scanned(rel):
    path = os.path.normpath(os.path.join(PKG, rel))
    if not rel.startswith(".."):
        assert path in _port_files()
    assert not [n for n, _ in _imported_roots(path) if n in FORBIDDEN]


def test_inference_engine_needs_cuda_or_explicit_cpu(monkeypatch):
    import mxnet_tpu_torch as mx

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = mx.gluon.nn.Dense(3, in_units=2)
    net.initialize(ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.serving.InferenceEngine(net, [(2,)])
    eng = mx.serving.InferenceEngine(net, [(2,)], ctx=mx.cpu())
    try:
        assert eng.predict([1.0, 2.0], timeout=10.0).shape == (1, 3)
    finally:
        eng.close()


# the data path (recordio, the native data plane, mx.image, mx.io,
# gluon.data) and the small modules of the seventeenth slice
DATA_MODULES = ("recordio.py", "_native.py", "image/__init__.py",
                "image/image.py", "image/detection.py", "io/__init__.py",
                "io/io.py", "ops/image_ops.py", "ndarray/image.py",
                "gluon/data/dataset.py", "gluon/data/sampler.py",
                "gluon/data/dataloader.py", "gluon/data/prefetcher.py",
                "gluon/data/stream.py", "gluon/data/vision/__init__.py",
                "gluon/data/vision/datasets.py",
                "gluon/data/vision/transforms.py", "runtime.py", "util.py",
                "name.py", "attribute.py")


@pytest.mark.parametrize("rel", DATA_MODULES)
def test_data_modules_are_scanned(rel):
    path = os.path.join(PKG, rel)
    assert path in _port_files()
    assert not [n for n, _ in _imported_roots(path) if n in FORBIDDEN]


def _string_constants(path):
    tree = ast.parse(open(path).read(), filename=path)
    return [(node.value, node.lineno) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_loads_the_reference_library(path):
    """The JAX package's ``cxx/libmxtpu.so`` is never a path the port
    builds or loads: ``_native.py`` builds ``libmxtpu_io-<hash>.so``
    into ``mxnet_tpu_torch/_build/``. A docstring may name the file."""
    tree = ast.parse(open(path).read(), filename=path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            doc = ast.get_docstring(node, clean=False)
            if doc is not None:
                docs.add(doc)
    bad = [(v, line) for v, line in _string_constants(path)
           if "libmxtpu.so" in v and v not in docs]
    assert not bad, f"{os.path.relpath(path, ROOT)} names {bad}"


def test_data_path_imports_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import mxnet_tpu_torch as mx; mx.io.ImageRecordIter; "
            "mx.gluon.data.DataLoader; mx.gluon.data.vision.transforms; "
            "mx.image.imdecode; mx.recordio.pack; mx.nd.image.to_tensor; "
            "from mxnet_tpu_torch import _native; _native.get_lib(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_data_path_stages_to_the_card_only_when_asked(monkeypatch):
    """The data path works on host arrays; the card is reached through
    ``DevicePrefetcher``/``DataLoader(device=...)``, which without a
    card raises for a CUDA device rather than staying on the host."""
    import numpy as np

    import mxnet_tpu_torch as mx

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = mx.gluon.data.ArrayDataset(np.zeros((4, 2), np.float32),
                                    np.zeros(4, np.float32))
    x, _ = next(iter(mx.gluon.data.DataLoader(ds, batch_size=2)))
    assert x.context == mx.cpu()
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.gluon.data.DataLoader(ds, batch_size=2, device=mx.gpu(0))
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.gluon.data.DevicePrefetcher([], device=mx.gpu(0))
