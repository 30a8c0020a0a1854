"""chip_smoke.py and bench.py off the card: both must fail loudly with
no accelerator, never fall back to the CPU; the smoke's inputs are
deterministic."""

import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    p = _run(["chip_smoke.py"], REPO)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "env" in p.stdout  # it stopped at the first phase


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the
    repo it fails before starting any phase."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(["chip_smoke.py"], str(tmp_path))
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_bench_requires_gpu():
    p = _run(["bench.py", "65536", "1"], REPO)
    assert p.returncode != 0
    assert "needs a GPU" in p.stderr
    assert p.stdout.strip() == ""


def test_chip_smoke_image_deterministic():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    a = chip_smoke.make_image(1 << 20, seed=3)
    b = chip_smoke.make_image(1 << 20, seed=3)
    c = chip_smoke.make_image(1 << 20, seed=4)
    assert a.dtype == np.uint8 and len(a) == 1 << 20
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # forensic shape: mostly zero sectors, every planted text present
    assert (a == 0).mean() > 0.8
    for m in chip_smoke._MESSAGES:
        assert bytes(a).find(m) >= 0, m
