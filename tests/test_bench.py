"""bench.py's plumbing, run small on the CPU.

The benchmark times the card at the rows' real shapes; what can break
silently between PRs is the plumbing — a row naming a loop configuration
that no longer constructs, a record that stops naming its device, or a
failed row that no longer fails the run.  Every ``SPECS`` row runs here
through the same ``bench_row -> build -> marginal`` path at tiny sizes.
"""

import json

import jax
import numpy as np
import pytest

import bench
from wrf_tpu.parallel.mesh import make_mesh

TINY = (24, 20, 8)


@pytest.mark.parametrize("spec", bench.SPECS, ids=[s[0] for s in bench.SPECS])
def test_spec_row_executes(spec):
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    rec = bench.bench_row(spec, mesh, "xla", repeats=1, counts=(2, 4),
                          dims=TINY)
    assert rec["config"] == spec[0] and rec["kernel"] == "xla"
    assert np.isfinite(rec["ms_per_substep"])


def test_spec_row_fused_kernel_interpreted():
    spec = next(s for s in bench.SPECS if s[5])   # the coupled+w row
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    rec = bench.bench_row(spec, mesh, "triton", repeats=1, counts=(2, 3),
                          dims=TINY, interpret=True)
    assert np.isfinite(rec["ms_per_substep"])


def test_main_refuses_without_gpu(capsys):
    """No fallback to the CPU: the run fails and prints no record."""
    assert bench.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no GPU" in captured.err


def test_failed_row_fails_the_run(capsys):
    mesh = make_mesh(jax.devices()[:1], (1, 1))
    good = bench.SPECS[0]
    bad = ("empty grid", 0, 0, 0, True, False, (2, 4))
    device = bench.device_record("card, 1 W")
    records, failed = bench.run_rows([good, bad], mesh, "xla", device,
                                     repeats=1, counts=(2, 4))
    assert failed == ["empty grid"]
    assert "error" in records[1] and "error" not in records[0]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["config"] for x in lines] == [good[0], bad[0]]


def test_records_name_the_device():
    rec = bench.device_record("NVIDIA H100 80GB HBM3, 700.00 W")
    assert rec == {"platform": jax.devices()[0].platform,
                   "device_kind": jax.devices()[0].device_kind,
                   "device_count": len(jax.devices()),
                   "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}


def test_rows_default_to_each_loops_own_path():
    """Without --kernel each row runs its loop's own choice, and the record
    names it: at these small shapes XLA, except with w, where the loop
    picks the fused kernel and, off a GPU, refuses it."""
    from wrf_tpu.io import fixtures

    mesh = make_mesh(jax.devices()[:1], (1, 1))
    case = fixtures.make_case(*TINY, halo=3, seed=42)
    for spec in bench.SPECS:
        if spec[5]:
            with pytest.raises(ValueError, match="needs a GPU"):
                bench.build(mesh, case, 2, coupled=spec[4], with_w=True)
            continue
        _, kernel = bench.build(mesh, case, 2, coupled=spec[4],
                                with_w=False)
        assert kernel == "xla", spec[0]
