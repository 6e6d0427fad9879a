"""chip_smoke.py refuses to report without a GPU, and without the repo."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(cwd, script):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, where):
    if where == "repo":
        cwd, script = ROOT, ROOT / "chip_smoke.py"
    else:
        cwd = tmp_path
        script = Path(shutil.copy(ROOT / "chip_smoke.py", tmp_path))
    r = _run(cwd, script)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
