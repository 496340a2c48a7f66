"""Entry-point contracts: the compile-cache helper, the multi-device dry run's
refusal to move platforms, and chip_smoke.py's device gate."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import jax

from mpctsid_tpu.utils import CHECKOUT_CACHE_DIR, configure_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "no_env"])
def test_compile_cache_placement(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert configure_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; the helper changes nothing
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert configure_compile_cache() == CHECKOUT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == CHECKOUT_CACHE_DIR
        assert CHECKOUT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_dryrun_multichip_refuses_too_few_devices():
    import __graft_entry__ as g
    n = len(jax.devices())
    with pytest.raises(RuntimeError, match="needs"):
        g.dryrun_multichip(n + 1)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True and "device" in line:
                return True
        except ValueError:
            continue
    return False


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_exits_nonzero_without_gpu(where, tmp_path):
    """No GPU: exit non-zero at once and print no result line — in the
    checkout (the device gate refuses), and in a directory holding
    chip_smoke.py and nothing else (the package is missing)."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run_smoke(cwd)
    assert r.returncode != 0
    assert not _printed_result(r.stdout), r.stdout
    if where == "repo":
        assert "needs a GPU" in r.stderr
    else:
        assert "No module named 'mpctsid_tpu'" in r.stderr
