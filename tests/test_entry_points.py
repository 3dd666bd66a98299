"""Entry-point contracts checked in fresh processes: where the compile
cache and the GCPS capacity hints go, and that chip_smoke.py refuses to
run without a GPU."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child(code: str, env_over: dict, drop=()) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO, **env_over})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cache_dir_from_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled executables and the
    capacity hints land there."""
    cache = tmp_path / "cc"
    code = """
import jax, numpy as np
import alga_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
from alga_tpu.core import packing
from alga_tpu.graph import device_join
rng = np.random.default_rng(0)
g = "".join("ACGT"[i] for i in rng.integers(0, 4, 600))
packed, lengths = packing.pack_strings([g[i:i + 60] for i in range(0, 540, 5)])
device_join.gcps_graph_device(packed, lengths, len(lengths), 30, 500, 45, 3)
print(jax.config.jax_compilation_cache_dir)
print(device_join._hints_path())
"""
    p = _child(code, {"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert p.returncode == 0, p.stderr[-2000:]
    cfg_dir, hints = p.stdout.split()[-2:]
    assert cfg_dir == str(cache)
    assert hints == str(cache / "gcps_cap_hints.json")
    assert os.path.exists(hints)
    compiled = [f for f in os.listdir(cache) if f != "gcps_cap_hints.json"]
    assert compiled, "no compiled executable was cached"


def test_cache_dir_default_in_checkout():
    """Without the env var, cache and hints share <repo>/.jax_cache."""
    code = """
import jax
import alga_tpu
from alga_tpu.graph import device_join, device_scale
print(jax.config.jax_compilation_cache_dir)
print(device_join._hints_path())
print(device_scale._hints_file())
"""
    p = _child(code, {}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert p.returncode == 0, p.stderr[-2000:]
    d = os.path.join(REPO, ".jax_cache")
    assert p.stdout.split()[-3:] == [
        d, os.path.join(d, "gcps_cap_hints.json"),
        os.path.join(d, "gcps_scale_hints.json")]


def test_chip_smoke_refuses_cpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
