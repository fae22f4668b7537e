"""Tests that need the card: detections, the fused pass's planes and the
device glyph read against the numpy oracle at the resolutions players use.

Each case runs in a child process on the GPU, because this process is held
to the CPU by conftest.py. The fixture decides whether a card is present;
on a host without one every case skips. On the card:

    python -m pytest tests/ -m chip
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from smh_tpu import device_info

ROOT = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.chip

_CASE = """
import json, sys
import chip_smoke as s
w, h = {w}, {h}
print(json.dumps([
    s.phase_device_march(w, h),
    s.phase_fused_parity(w, h, memory_analysis=False),
    s.phase_live(w, h, 2, oracle_workers=1),
]))
"""


@pytest.fixture(scope="module")
def gpu_env() -> dict:
    """The environment of a child process that gets the card: without the
    CPU forcing conftest.py put into this process's environment."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no nvidia-smi: not a GPU host")
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    dev = device_info.probe(env)
    if dev["platform"] != "gpu":
        pytest.skip(f"JAX's default platform is {dev['platform']!r}, not gpu")
    return env


@pytest.mark.parametrize("w,h", [(1920, 1080), (2560, 1440), (3840, 2160)])
def test_device_matches_oracle_on_gpu(gpu_env, w, h):
    proc = subprocess.run(
        [sys.executable, "-c", _CASE.format(w=w, h=h)], cwd=ROOT, env=gpu_env,
        capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    march, parity, live = json.loads(proc.stdout.strip().splitlines()[-1])
    assert march["lsd_engine"] == "tpu"
    assert parity["text"] == "300m"
    assert live["platform"] == "gpu" and live["device_scales_fallbacks"] == 0
