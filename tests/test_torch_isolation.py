"""The PyTorch port stands alone: no file of ``mxnet_tpu_torch/`` and not
``chip_smoke.py`` imports JAX or any module of the JAX package
``mxnet_tpu`` (matched by exact top-level name, so ``mxnet_tpu_torch``
itself is allowed); importing the port's serving and training surfaces
loads no JAX; and without a CUDA card the entry points refuse to run
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
