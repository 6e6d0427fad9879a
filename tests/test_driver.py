"""L4 tests: the Python CLI verification driver."""

import numpy as np
import pytest

from wrf_tpu import driver
from wrf_tpu.io import codec, fixtures


def test_driver_numpy_tier(tmp_path, small_case, capsys):
    d = fixtures.write_case(small_case, tmp_path / "fx", steps=2)
    rc = driver.main([str(d), "--tier", "numpy"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("max_ulp=0") == 7  # bit-exact on every field
    assert "grid-points/s" in out


def test_driver_xla_tier(tmp_path, small_case, capsys):
    d = fixtures.write_case(small_case, tmp_path / "fx", steps=2)
    rc = driver.main([str(d), "--tier", "xla"])
    assert rc == 0


def test_driver_coupled_tier(tmp_path, small_case, capsys):
    """The coupled-loop tier verifies against the in-process golden loop
    (uv + mu/t + implicit w), mesh-decomposed."""
    d = fixtures.write_case(small_case, tmp_path / "fx", steps=3)
    rc = driver.main([str(d), "--tier", "coupled", "--with-w", "--mesh", "2x2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "w (golden loop)" in out and "pp (golden loop)" in out


def test_driver_steps_override_fails(tmp_path, small_case, capsys):
    """Wrong step count must be detected by the comparators."""
    d = fixtures.write_case(small_case, tmp_path / "fx", steps=3)
    rc = driver.main([str(d), "--tier", "numpy", "--steps", "1"])
    assert rc == 1
    assert "FAILED" in capsys.readouterr().out


def test_driver_dump_intermediates(tmp_path, small_case):
    """The *_before_theta capture mode (reference:
    module_small_step_em.f90:175-189) writes phase-A fields that match the
    final mu-phase outputs (advance_mu_t never revisits them in phase B)."""
    d = fixtures.write_case(small_case, tmp_path / "fx", steps=1)
    dump = tmp_path / "dump"
    rc = driver.main([str(d), "--tier", "xla", "--dump-intermediates", str(dump)])
    assert rc == 0
    b = small_case.bounds
    golden = fixtures.read_golden(d, b)
    mu_cap = codec.read_field(dump / "mu_before_theta.bin", b.shape2)
    # XLA reassociates the k reduction -> allclose, not bitwise, vs native
    np.testing.assert_allclose(mu_cap, golden["mu"], atol=1e-4)
    ww_cap = codec.read_field(dump / "ww_before_theta.bin", b.shape3)
    np.testing.assert_allclose(ww_cap, golden["ww"], atol=1e-5)
    assert (dump / "muave_before_theta.bin").exists()
    assert (dump / "muts_before_theta.bin").exists()


def test_dump_intermediates_tier_uniform(tmp_path, small_case):
    """Every capture-capable tier (numpy, native, xla) produces the same
    five *_before_theta phase-A snapshots — the bisection workflow the
    reference enables only in Fortran works across the tier matrix.  The
    scalar tiers must agree bit-for-bit; the XLA tier within the
    k-reduction reassociation tolerance."""
    d = fixtures.write_case(small_case, tmp_path / "fx", steps=2)
    b = small_case.bounds
    names = ("muave_before_theta", "mu_before_theta", "mudf_before_theta",
             "muts_before_theta", "ww_before_theta")
    caps = {}
    for tier in ("numpy", "native", "xla"):
        dump = tmp_path / f"dump_{tier}"
        rc = driver.main([str(d), "--tier", tier,
                          "--dump-intermediates", str(dump)])
        assert rc == 0, tier
        caps[tier] = {
            n: codec.read_field(
                dump / f"{n}.bin",
                b.shape3 if n.startswith("ww") else b.shape2,
                nan_check=False)
            for n in names
        }
    for n in names:
        np.testing.assert_array_equal(
            caps["native"][n], caps["numpy"][n], err_msg=f"native {n}")
        for tier in ("xla",):
            ref = caps["numpy"][n]
            scale = max(float(np.abs(ref).max()), 1.0)
            # device tiers zero the never-computed halo edge cells of the
            # captures; restrict to the interior window
            sl = ((slice(1, -1), slice(None), slice(1, -1))
                  if ref.ndim == 3 else (slice(1, -1), slice(1, -1)))
            np.testing.assert_allclose(
                caps[tier][n][sl], ref[sl], rtol=1e-4, atol=1e-5 * scale,
                err_msg=f"{tier} {n}")
    assert (dump / "mudf_before_theta.bin").exists()


def test_driver_coupled_native_tier(tmp_path, small_case, capsys):
    """The native C++ coupled loop through the CLI is bit-identical to the
    golden loop (max_ulp=0 on every compared field)."""
    d = fixtures.write_case(small_case, tmp_path / "fx", steps=3)
    rc = driver.main([str(d), "--tier", "coupled-native", "--with-w"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [l for l in out.splitlines() if "golden loop" in l]
    assert lines and all("max_ulp=0" in l for l in lines), out


@pytest.mark.full
def test_driver_all_tiers(tmp_path, small_case, capsys):
    """The side-by-side tier matrix covers the FULL tier set — the four
    single-substep tiers, both sharded tiers, the three coupled tiers and
    their +w variants (the triton tiers in the Pallas interpreter) — and
    every row PASSes, with the scalar tiers bit-exact."""
    d = fixtures.write_case(small_case, tmp_path / "fx", steps=3)
    rc = driver.main([str(d), "--tier", "all", "--mesh", "2x2",
                      "--interpret"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("PASS") == len(driver.ALL) == 12
    assert "FAIL" not in out and "ERROR" not in out
    for tier in ("numpy", "native"):
        line = next(l for l in out.splitlines() if l.strip().startswith(tier))
        assert "max_abs=0.000e+00" in line


@pytest.mark.parametrize("tier", ["triton", "sharded-triton",
                                  "coupled-triton"])
def test_driver_triton_tiers_interpreted(tmp_path, small_case, tier):
    """The fused-kernel tiers, run in the Pallas interpreter, pass the
    same acceptance as the XLA tiers."""
    d = fixtures.write_case(small_case, tmp_path / "fx", steps=2)
    args = [str(d), "--tier", tier, "--interpret"]
    if tier != "triton":
        args += ["--mesh", "2x2"]
    assert driver.main(args) == 0


def test_driver_triton_tier_needs_gpu(tmp_path, small_case):
    """The triton tier compiles the fused kernel for the GPU: without one
    (and without --interpret) it fails instead of falling back to the
    CPU."""
    d = fixtures.write_case(small_case, tmp_path / "fx", steps=1)
    with pytest.raises(Exception):
        driver.main([str(d), "--tier", "triton"])
