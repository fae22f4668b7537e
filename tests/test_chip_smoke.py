"""chip_smoke.py off the card: it refuses a host without a GPU before it
compiles anything, and its phase helpers agree with the numpy oracle at a
small size on the CPU (the chip run repeats them at 4K and 1080p)."""

from __future__ import annotations

import os
import pathlib
import stat
import subprocess
import sys

import pytest

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _fake_nvidia_smi(tmp_path: pathlib.Path) -> dict:
    """An environment whose nvidia-smi answers, on the CPU platform: only
    the JAX platform check can stop the run."""
    exe = tmp_path / "nvidia-smi"
    exe.write_text("#!/bin/sh\necho 'Fake GPU, 1.00 W'\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PATH=f"{tmp_path}{os.pathsep}{os.environ.get('PATH', '')}")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_cpu_before_compiling(script, tmp_path):
    proc = subprocess.run(
        [sys.executable, script], cwd=ROOT, env=_fake_nvidia_smi(tmp_path),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"phase"' not in proc.stdout
    assert "no GPU" in proc.stderr and "'cpu'" in proc.stderr


@pytest.mark.parametrize("phase", ["live", "batch", "device_march", "fused_parity"])
def test_phase_helpers_match_oracle_on_cpu(phase, monkeypatch):
    w, h = 640, 360
    if phase == "live":
        out = chip_smoke.phase_live(w, h, 3, oracle_workers=1, expect_platform="cpu")
        assert out["backend"] == "tpu" and out["device_scales_frames"] >= 1
    elif phase == "batch":
        monkeypatch.setenv("SMH_DELTA", "1")  # small frames: force the delta chain
        out = chip_smoke.phase_batch(chip_smoke.smoke_frames(w, h, 8), batch=4, oracle_workers=1)
        assert out["delta_batches"] >= 1
    elif phase == "device_march":
        out = chip_smoke.phase_device_march(w, h)
        assert out["lsd_engine"] == "tpu" and out["lines"] == 2
    else:
        out = chip_smoke.phase_fused_parity(w, h, memory_analysis=False)
        assert out["text"] == "300m"
        assert out["marker_mask_agreement"] >= chip_smoke.MASK_AGREEMENT
        return
    assert out["max_endpoint_diff_px"] <= chip_smoke.LINE_TOL_PX


def test_compare_rejects_out_of_band_detections():
    base = {"sleeping": False, "markers": [[1.0, 2.0, 30.0, 40.0]], "ratio": 2.5,
            "minimap": [0, 0, 10, 10]}
    assert chip_smoke.compare(dict(base), base, "same") == 0.0
    for bad in ({"markers": [[1.0, 2.0, 32.0, 40.0]]}, {"markers": []},
                {"ratio": 2.5 * (1 + 1e-5)}, {"ratio": None}, {"minimap": [0, 0, 10, 11]}):
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.compare({**base, **bad}, base, "bad")
