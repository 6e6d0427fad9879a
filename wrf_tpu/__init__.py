"""wrf_tpu — a JAX WRF-style dynamical-core framework for GPUs.

A from-scratch JAX/XLA re-design of the capabilities of the reference
``wrf-model-cuda-sample`` (WRF V3.4.1 ``advance_mu_t`` acoustic small-step
dynamics in Fortran/C/CUDA): the same numerics and verification
architecture — whole-array XLA stencils, ``shard_map`` 2-D domain
decomposition over a device mesh with ``ppermute`` halo exchange, vertical
column scans kept device-local, plus a native C++ scalar oracle tier and the
reference's golden-file differential-testing methodology.

Layers (mirroring the reference's architecture, SURVEY.md §1):
  L1 foundation  — ``grid``, ``config``, ``compare``, ``io``
  L2 numerics    — ``ops`` (numpy golden path, XLA path, a fused
                   Pallas-Triton column kernel)
                   and ``native`` (C++ scalar oracle)
  L3 parallel    — ``parallel`` (mesh, halo exchange, sharded stepping)
  L4 drivers     — ``models`` (small-step loop, RK3), CLI drivers
                   (``python -m wrf_tpu.driver`` verification,
                   ``python -m wrf_tpu.run_sim`` simulation), pytest harness
"""

from .grid import ConfigFlags, GridBounds
from .compare import CompareResult, compare, compare_window, float_ulps

__version__ = "0.1.0"

__all__ = [
    "ConfigFlags",
    "GridBounds",
    "CompareResult",
    "compare",
    "compare_window",
    "float_ulps",
    "__version__",
]
