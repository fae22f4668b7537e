"""The committed glyph data (smh_tpu/ocr/glyphs.npz) and the compile-cache
location, both of which the program relies on without the tools that
produced them."""

from __future__ import annotations

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from smh_tpu.ocr import glyphs

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_committed_glyphs_equal_a_fresh_render():
    pytest.importorskip("PIL")
    spec = importlib.util.spec_from_file_location("gen_glyphs", ROOT / "tools" / "gen_glyphs.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    if not all((gen.FONT_DIR / f).exists() for f in gen.FONTS.values()):
        pytest.skip("DejaVu Sans not installed")
    fresh = gen.render()
    with np.load(glyphs.GLYPHS_NPZ) as committed:
        assert sorted(committed.files) == sorted(fresh)
        for key, arr in fresh.items():
            assert committed[key].dtype == arr.dtype, key
            assert np.array_equal(committed[key], arr), key


def _cache_dir(env: dict) -> str:
    code = ("import jax, smh_tpu.ops.pipeline; "
            "print(jax.config.jax_compilation_cache_dir)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, check=True)
    return proc.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(env_set, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "x")
        assert _cache_dir(env) == str(tmp_path / "x")
    else:
        assert _cache_dir(env) == str(ROOT / ".jax_cache")
