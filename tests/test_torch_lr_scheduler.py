"""Port parity: ``mxnet_tpu_torch.lr_scheduler`` against the JAX
package's: every scheduler, with and without warmup, over 50 updates
(called in order, as an optimizer calls it, then again from the start:
the schedulers keep state). The schedulers are host arithmetic in Python
floats on both sides, so the rates must be equal.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

CASES = {
    "factor": ("FactorScheduler", dict(step=7, factor=0.5, base_lr=0.1)),
    "factor_floor_warmup": ("FactorScheduler", dict(
        step=3, factor=0.1, stop_factor_lr=1e-4, base_lr=0.2,
        warmup_steps=5, warmup_begin_lr=0.01)),
    "multifactor": ("MultiFactorScheduler", dict(step=[5, 12, 30],
                                                 factor=0.3, base_lr=1.0)),
    "multifactor_warmup": ("MultiFactorScheduler", dict(
        step=[10, 20], factor=0.5, base_lr=0.5, warmup_steps=8,
        warmup_mode="constant")),
    "poly": ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=2,
                                   final_lr=0.001)),
    "poly_warmup": ("PolyScheduler", dict(max_update=45, base_lr=0.3,
                                          pwr=1, warmup_steps=6,
                                          warmup_begin_lr=0.05)),
    "cosine": ("CosineScheduler", dict(max_update=50, base_lr=0.1,
                                       final_lr=0.0)),
    "cosine_warmup": ("CosineScheduler", dict(
        max_update=35, base_lr=0.4, final_lr=0.01, warmup_steps=10,
        warmup_mode="constant")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fifty_updates_match_jax(case):
    name, kwargs = CASES[case]
    jsched = getattr(jmx.lr_scheduler, name)(**kwargs)
    tsched = getattr(mx.lr_scheduler, name)(**kwargs)
    want = [jsched(n) for n in range(1, 51)]
    got = [tsched(n) for n in range(1, 51)]
    assert got == want
    assert len(set(got)) > 1
    assert [tsched(n) for n in (1, 25, 50)] == \
        [jsched(n) for n in (1, 25, 50)]


def test_base_scheduler_is_abstract():
    with pytest.raises(NotImplementedError):
        mx.lr_scheduler.LRScheduler()(1)
