"""Process-level behaviour of the entry points: the compile-cache helper
(utils/jax_setup.py) and chip_smoke.py's refusal to run without a GPU.

Each case runs a fresh interpreter, because both decide things when a
process starts."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, jax, jax.numpy as jnp
from visual_inertial_bundle_adjustment_tpu.utils.jax_setup import (
    checkout_cache_dir, setup_jax)
cache = setup_jax()
jax.jit(lambda x: jnp.sin(x) * 3.0 + x)(jnp.arange(7.0)).block_until_ready()
print(json.dumps({"cache": cache, "config": jax.config.jax_compilation_cache_dir,
                  "checkout": checkout_cache_dir()}))
"""


def _run(code_or_args, env_update, unset=(), cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_update)
    for k in unset:
        env.pop(k, None)
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(args, env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_compile_cache_from_environment(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: compiled entries land there and the
    helper sets no directory of its own."""
    r = _run(_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["cache"] == str(tmp_path) == out["config"]
    assert any(tmp_path.iterdir()), "no compiled entry in the given directory"


def test_compile_cache_defaults_to_checkout():
    """JAX_COMPILATION_CACHE_DIR unset: the cache is <checkout>/.jax_cache,
    a fixed path (never a temporary name, pid or time)."""
    r = _run(_PROBE, {}, unset=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["cache"] == out["config"] == out["checkout"] == os.path.join(
        ROOT, ".jax_cache")
    assert os.path.isdir(out["cache"]) and os.listdir(out["cache"])


def test_chip_smoke_refuses_cpu(tmp_path):
    """No GPU: chip_smoke exits non-zero and prints no result, both in the
    checkout and alone in a directory without the package."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for args, cwd in (([sys.executable, "chip_smoke.py"], ROOT),
                      ([sys.executable, str(alone)], str(tmp_path))):
        r = _run(args, {}, cwd=cwd)
        assert r.returncode != 0, (cwd, r.stdout[-500:])
        assert '"ok": true' not in r.stdout, (cwd, r.stdout[-500:])
