"""End-to-end simulation driver: namelist config, RK3 steps, checkpoint
stop-and-resume continuity."""

import json

import pytest

import numpy as np

from wrf_tpu import run_sim
from wrf_tpu.io import checkpoint, fixtures


def _fixture(tmp_path, case, calm: bool = False):
    """Write a fixture; ``calm`` scales the winds/theta down so repeated
    RK3 large steps stay stable (the default noise-like fields have no
    physical balance and blow up after ~2 large steps — on the golden
    path too, this is physics not implementation)."""
    if calm:
        import dataclasses
        import numpy as np
        f = {k: np.array(v, copy=True) for k, v in case.fields.items()}
        for name in ("grid_u_2", "grid_v_2", "grid_u_save", "grid_v_save"):
            f[name] = f[name] * np.float32(1e-2)
        for name in ("grid_t_2", "t_2save", "grid_ww"):
            f[name] = f[name] * np.float32(1e-1)
        case = dataclasses.replace(case, fields=f)
    return str(fixtures.write_case(case, tmp_path / "fx", steps=1))


@pytest.mark.full
def test_run_sim_smoke(tmp_path, small_case, capsys):
    d = _fixture(tmp_path, small_case)
    rc = run_sim.main([d, "--kernel", "xla",
                       "--steps", "2", "--mesh", "2x2", "--with-w",
                       "--diagnostics", "--profile",
                       str(tmp_path / "trace")])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("grid-points/s") == 2
    assert out.count("total dry mass") == 2
    assert (tmp_path / "trace").exists()


@pytest.mark.full
def test_run_sim_namelist(tmp_path, small_case, capsys):
    d = _fixture(tmp_path, small_case)
    nml = tmp_path / "nml.json"
    nml.write_text(json.dumps({
        "dx": 12000.0, "dy": 12000.0, "time_step": 12,
        "time_step_sound": 6, "epssm": 0.1, "smdiv": 0.1,
        "specified": True,
    }))
    rc = run_sim.main([d, "--kernel", "xla", "--namelist", str(nml),
                       "--steps", "1"])
    assert rc == 0


def test_run_sim_namelist_input_text(tmp_path, small_case, capsys):
    """A WRF Fortran namelist.input text file is accepted directly
    (auto-detected vs the JSON form)."""
    d = _fixture(tmp_path, small_case)
    nml = tmp_path / "namelist.input"
    nml.write_text("""
&domains
 time_step       = 12,
 dx              = 12000.0, 4000.0,
 dy              = 12000.0, 4000.0,
/
&dynamics
 epssm           = 1.d-1,
 smdiv           = 0.1,
 time_step_sound = 6,
/
&bdy_control
 specified = .true.
/
""")
    rc = run_sim.main([d, "--kernel", "xla", "--namelist", str(nml),
                       "--steps", "1"])
    assert rc == 0


@pytest.mark.full
def test_run_sim_checkpoint_resume(tmp_path, small_case, capsys):
    """2 steps + resume 1 == 3 straight steps, bit-for-bit (the snapshot
    format is the full carried state)."""
    d = _fixture(tmp_path, small_case, calm=True)
    ck = tmp_path / "ck"
    rc = run_sim.main([d, "--kernel", "xla",
                       "--steps", "3", "--checkpoint-dir",
                       str(tmp_path / "ck3")])
    assert rc == 0
    straight, _, _ = checkpoint.load_checkpoint(tmp_path / "ck3" / "step_000003")

    rc = run_sim.main([d, "--kernel", "xla",
                       "--steps", "2", "--checkpoint-dir", str(ck)])
    assert rc == 0
    rc = run_sim.main([d, "--kernel", "xla",
                       "--steps", "1", "--checkpoint-dir", str(ck),
                       "--resume"])
    assert rc == 0
    assert "resuming from" in capsys.readouterr().out
    resumed, step, _ = checkpoint.load_checkpoint(ck / "step_000003")
    assert step == 3
    for name in ("ww", "mu", "t", "u", "v"):
        np.testing.assert_array_equal(resumed[name], straight[name],
                                      err_msg=name)


@pytest.mark.full
def test_run_sim_steps_per_sync(tmp_path, small_case, capsys):
    """--steps-per-sync K runs K large steps device-resident per launch;
    the final checkpoint matches host stepping to a few ulp and the
    per-step diagnostics series is still printed."""
    d = _fixture(tmp_path, small_case, calm=True)
    rc = run_sim.main([d, "--kernel", "xla",
                       "--steps", "4", "--closure", "nudge",
                       "--diagnostics",
                       "--checkpoint-dir", str(tmp_path / "ck_host")])
    assert rc == 0
    rc = run_sim.main([d, "--kernel", "xla",
                       "--steps", "4", "--closure", "nudge",
                       "--diagnostics", "--steps-per-sync", "2",
                       "--checkpoint-dir", str(tmp_path / "ck_fused")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "device-resident" in out
    assert out.count("total dry mass") >= 8  # 4 host + 4 fused
    host, _, _ = checkpoint.load_checkpoint(tmp_path / "ck_host" / "step_000004")
    fused, _, _ = checkpoint.load_checkpoint(tmp_path / "ck_fused" / "step_000004")
    for name in ("t", "mu", "u", "v", "ww"):
        scale = np.max(np.abs(host[name])) or 1.0
        np.testing.assert_allclose(fused[name], host[name], rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=name)


@pytest.mark.full
def test_resume_nudge_reference_continuity(tmp_path, small_case, capsys):
    """A resumed --closure nudge run must relax toward the run's ORIGINAL
    base state, not the checkpointed state: 2 steps + resume 2 equals 4
    straight steps bit-for-bit."""
    d = _fixture(tmp_path, small_case, calm=True)
    common = [d, "--kernel", "xla", "--closure", "nudge"]
    rc = run_sim.main(common + ["--steps", "4", "--checkpoint-dir",
                                str(tmp_path / "ck4")])
    assert rc == 0
    straight, _, _ = checkpoint.load_checkpoint(tmp_path / "ck4" / "step_000004")

    ck = tmp_path / "ck_res"
    rc = run_sim.main(common + ["--steps", "2", "--checkpoint-dir", str(ck)])
    assert rc == 0
    rc = run_sim.main(common + ["--steps", "2", "--checkpoint-dir", str(ck),
                                "--resume"])
    assert rc == 0
    resumed, step, _ = checkpoint.load_checkpoint(ck / "step_000004")
    assert step == 4
    for name in ("t", "mu", "u", "v", "ww"):
        np.testing.assert_array_equal(resumed[name], straight[name],
                                      err_msg=name)
