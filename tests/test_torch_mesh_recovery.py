"""The supervisor's SIGKILL drill under a mesh, in the port: each attempt
is a group of 2 gloo rank processes started with torchrun's environment,
every rank is killed at the same round, and the recovered result map
equals the uninterrupted baseline's (ci.yml's last drill, on 2 ranks at 1
seed).  The mesh baseline in turn equals the JAX package's child on a
2-device mesh, status and steps included."""
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def test_supervisor_sigkill_drill_under_two_rank_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.supervise", "--crash-test",
         "--seeds", "1", "--kills", "2", "--queries", "6", "--snapshot-every", "2",
         "--out", str(tmp_path / "crash"), "--device", "cpu", "--ranks", "2"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "recovered ≡ uninterrupted" in r.stdout
    assert "rc=-9" in r.stdout and "ranks=2" in r.stdout

    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
    j = subprocess.run(
        [sys.executable, "-m", "repro.launch.supervise", "--child", "--seed", "0",
         "--journal", str(tmp_path / "jax.wal"), "--result", str(tmp_path / "jax.json"),
         "--queries", "6", "--snapshot-every", "2"],
        capture_output=True, text=True, env=jax_env, cwd=str(tmp_path), timeout=300)
    assert j.returncode == 0, j.stderr[-3000:]
    base = tmp_path / "crash" / "seed_0" / "baseline.json"
    assert json.loads(base.read_text()) == json.loads((tmp_path / "jax.json").read_text())
