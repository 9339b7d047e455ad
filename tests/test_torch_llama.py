"""Port parity: ``mxnet_tpu_torch.models.llama`` against the JAX package's
``models/llama.py`` on the same numpy inputs.

Two small configurations: ``llama_tiny`` (vocab 256, 2 layers, units 64,
4 heads over 2 kv heads) and a narrow group-4 one with a sliding window
(8 heads over 2 kv heads, window 5). The port's net gets the JAX net's
initial weights name for name (``gluon.utils.load_numpy``); token ids
come from a numpy seed.

Tolerance (float32): logits within 1e-5 of the largest |logit| (two
layers of float32 products over at most 128 terms, RMSNorm and RoPE in
fp32 on both sides; they differ in summation order only, ~1e-6).
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.models import llama as jllama
from mxnet_tpu_torch.gluon.utils import load_numpy
from mxnet_tpu_torch.models import llama as tllama
from mxnet_tpu_torch.ops import _kernels

CONFIGS = {
    "llama_tiny": ("llama_tiny", {}),
    "gqa4_window": ("llama_tiny", dict(vocab_size=128, units=64,
                                       intermediate=96, num_heads=8,
                                       num_kv_heads=2, sliding_window=5)),
}
BATCH, SEQ = 2, 16


def _close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, \
        (float(np.abs(got - want).max()), scale)


def _ids(vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (BATCH, SEQ)) \
        .astype(np.float32)


def nets(config):
    """The JAX net and the port's, initialised, shapes resolved, and the
    port's weights carried from the JAX net's."""
    name, kw = CONFIGS[config]
    jnet = jllama.get_llama(name, **kw)
    jnet.initialize(init=jmx.initializer.Normal(0.02))
    tnet = tllama.get_llama(name, **kw)
    tnet.initialize(init=mx.initializer.Normal(0.02), ctx=mx.cpu())
    ids = _ids(tnet._cfg["vocab_size"])
    jnet(jmx.nd.array(ids))
    tnet(mx.nd.array(ids, ctx=mx.cpu()))
    load_numpy(tnet.collect_params(),
               {k.replace(jnet.prefix, tnet.prefix, 1):
                np.array(p.data().asnumpy())
                for k, p in jnet.collect_params().items()})
    return jnet, tnet


def test_parameter_names_equal_the_jax_package():
    jnet = jllama.llama_tiny()
    tnet = tllama.llama_tiny()
    want = [k.replace(jnet.prefix, tnet.prefix, 1)
            for k in jnet.collect_params().keys()]
    assert list(tnet.collect_params().keys()) == want
    assert f"{tnet.prefix}layers_l0_attn_q_weight" in want
    assert f"{tnet.prefix}layers_l1_mlp_gate_weight" in want
    assert tnet._cfg == jnet._cfg
    assert tllama._LLAMA_CONFIGS == jllama._LLAMA_CONFIGS


@pytest.mark.parametrize("config", list(CONFIGS))
def test_forward_matches_jax(config):
    jnet, tnet = nets(config)
    ids = _ids(tnet._cfg["vocab_size"], seed=1)
    want = np.array(jnet(jmx.nd.array(ids)).asnumpy())
    got = tnet(mx.nd.array(ids, ctx=mx.cpu())).asnumpy()
    assert got.shape == want.shape == (BATCH, SEQ, tnet._cfg["vocab_size"])
    _close(got, want, 1e-5)


@pytest.mark.parametrize("T", [1, 7, 16])
def test_rope_matches_jax(T):
    x = np.random.RandomState(T).randn(2, 3, T, 8).astype(np.float32)
    want = np.array(jllama._rope(x, 10000.0))
    got = tllama._rope(torch.from_numpy(x), 10000.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rms_norm_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, 16).astype(np.float32)
    w = rs.randn(16).astype(np.float32)
    jn = jllama.RMSNorm(16, eps=1e-5)
    jn.initialize()
    jn.weight.set_data(jmx.nd.array(w))
    tn = tllama.RMSNorm(16, eps=1e-5)
    tn.initialize(ctx=mx.cpu())
    tn.weight.set_data(w)
    want = np.array(jn(jmx.nd.array(x)).asnumpy())
    got = tn(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bf16_rms_norm_and_rope_keep_the_input_type():
    x = torch.randn(1, 2, 4, 8).bfloat16()
    assert tllama._rope(x).dtype == torch.bfloat16
    assert tllama._rms_norm(x, torch.ones(8), 1e-5).dtype == torch.bfloat16


def test_import_loads_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import mxnet_tpu_torch as mx; mx.models.llama3_8b; "
            "mx.parallel.SPMDTrainStep; mx.nd.sigmoid; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code, root], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_point_needs_cuda_or_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = mx.models.llama_tiny()
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        net.initialize()


@pytest.mark.parametrize("env,kernels", [
    ("fused", {"flash_fwd": 2, "flash_bwd_fused": 2}),
    ("split", {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}),
])
def test_attention_kernels_of_a_train_step_on_cuda(monkeypatch, env,
                                                   kernels):
    """One forward + backward of llama_tiny on the card launches K1 once
    per layer, and K6 (``fused``) or K2 (``split``) once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("MXTPU_FLASH_BWD", env)
    net = mx.models.llama_tiny()
    net.initialize(init=mx.initializer.Normal(0.02))
    x = mx.nd.array(_ids(256))
    net(x)
    sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    _kernels.LAUNCHES.clear()
    with mx.autograd.record():
        loss = sce(net(x).reshape((-1, 256)), x.reshape((-1,)))
    loss.backward()
    mx.nd.waitall()
    assert {k: v for k, v in _kernels.LAUNCHES.items() if v} == kernels
