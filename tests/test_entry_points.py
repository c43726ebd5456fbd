"""The scripts' contracts on a machine without a GPU, and where the
persistent compilation cache goes.  Each case runs a fresh Python
process, so no JAX configuration leaks into the test session."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke run exits non-zero before any phase and
    prints no result line."""
    p = _run(["chip_smoke.py"])
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "platform 'cpu'" in p.stdout + p.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding nothing of the repo but the script, it
    fails: it never runs an installed copy of the package."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run(["chip_smoke.py"], cwd=tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_bench_refuses_cpu():
    p = _run(["bench.py", "--quick"])
    assert p.returncode != 0
    assert "sweeps/s" not in p.stdout


_PROBE = (
    "import json, os, jax\n"
    "from ccfindr_tpu.utils import enable_compile_cache\n"
    "before = jax.config.jax_compilation_cache_dir\n"
    "path = enable_compile_cache() if os.environ.get('ENABLE') else None\n"
    "jax.jit(lambda v: v * 3 + 1)(2.0).block_until_ready()\n"
    "print(json.dumps([before, path, jax.config.jax_compilation_cache_dir]))\n"
)


def _probe(env_extra, drop=()):
    import json

    p = _run(["-c", _PROBE], env_extra=env_extra, drop=drop)
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_import_sets_no_cache():
    """Importing the library configures no compilation cache."""
    before, _, after = _probe({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert before is None and after is None


def test_compile_cache_env_var(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there
    and no other directory is configured."""
    cache = tmp_path / "cache"
    _, path, cfg = _probe({"JAX_COMPILATION_CACHE_DIR": str(cache),
                           "ENABLE": "1"})
    assert path == str(cache)
    assert cfg == str(cache)           # JAX's own reading of the variable
    assert cache.is_dir() and any(cache.iterdir())


def test_compile_cache_default_path(monkeypatch):
    """Unset, the cache directory is the fixed <checkout>/.jax_cache."""
    from ccfindr_tpu.utils import compile_cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == os.path.join(ROOT, ".jax_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert compile_cache_dir() == "/elsewhere"


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    """The whole smoke run on a card (minutes)."""
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1].startswith('{"ok": true')
