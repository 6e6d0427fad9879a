"""Checks on the card: the fused column kernel compiled for the GPU and the
loop on one device, against the XLA path and the golden loop.  They skip
without a GPU; chip_smoke.py runs the same functions (utils/gpu_checks.py).
"""

import pytest

from wrf_tpu.utils import gpu_checks


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(gpu_checks.CHECKS))
def test_gpu_check(gpu, name):
    assert gpu_checks.CHECKS[name]() <= 1.0
