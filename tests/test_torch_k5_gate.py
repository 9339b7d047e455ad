"""``chip_smoke.k5_grad_gate``: the rule that holds ResNet-50's gradient
with K5's Hopper kernels against a run with K5 in float64.

Each triple is (kernel run, fp32 plain K5 run, TF32 control run), each
the worst gradient distance to the float64 run. The first is the reading
an earlier 3xTF32 design of K5 gave on an NVIDIA H100 80GB HBM3 at
700.00 W (``chip_smoke.py``'s ``[resnet-parity] vs=float64_K5_same_forward``
line): the kernels were closer to exact arithmetic than the fp32 plain
version, and the TF32 control 49 times farther than the gate.
"""

import torch_threads  # noqa: F401  (a worker's share of the cores)
import pytest

import chip_smoke

MEASURED = (9.522e-5, 1.096e-4, 5.381e-3)


def test_measured_triple_passes():
    passes, gate = chip_smoke.k5_grad_gate(*MEASURED)
    assert passes
    assert gate == MEASURED[1]


@pytest.mark.parametrize("control", [1.096e-4, 5.0e-5])
def test_control_inside_the_gate_fails(control):
    """A control at or under the gate means the gate has no teeth."""
    passes, _ = chip_smoke.k5_grad_gate(MEASURED[0], MEASURED[1], control)
    assert not passes


def test_kernel_twice_the_plain_distance_fails():
    kernel = 2 * MEASURED[1]
    passes, gate = chip_smoke.k5_grad_gate(kernel, MEASURED[1], MEASURED[2])
    assert not passes and kernel > gate


def test_floor_is_the_old_tolerance():
    """A plain version closer than RESNET_GRAD_RTOL leaves that floor."""
    passes, gate = chip_smoke.k5_grad_gate(8e-5, 3e-6, 5e-3)
    assert passes and gate == chip_smoke.RESNET_GRAD_RTOL == 1e-4
    assert not chip_smoke.k5_grad_gate(1.2e-4, 3e-6, 5e-3)[0]
