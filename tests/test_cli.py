"""CLI flows via subprocess: heightmap tools + app startup/shutdown."""

import json
import pathlib
import signal
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
STUB = f"{sys.executable} -m smh_tpu.heightmaps.stub_ripper"


def run_cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "smh_tpu.app", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": "/root",
             "PYTHONPATH": str(REPO)},
    )


def test_cli_list_maps(tmp_path):
    # The ripper "executable" is the python stub; pass it as a single argv[0]
    # is not possible, so use a wrapper script.
    wrapper = tmp_path / "ripper.sh"
    wrapper.write_text(f"#!/bin/sh\nexec {STUB} \"$@\"\n")
    wrapper.chmod(0o755)

    r = run_cli("--list-maps", "--paks", "paks", "--ripper", str(wrapper))
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert any("Mutaha.umap" in l for l in lines)
    assert all("lighting_layers" not in l for l in lines)


def test_cli_rip_and_export(tmp_path):
    wrapper = tmp_path / "ripper.sh"
    wrapper.write_text(f"#!/bin/sh\nexec {STUB} \"$@\"\n")
    wrapper.chmod(0o755)
    png = tmp_path / "hm.png"

    r = run_cli(
        "--rip", "SquadGame/Content/Maps/Mutaha/Mutaha.umap",
        "--paks", "paks", "--ripper", str(wrapper),
        "--cache-dir", str(tmp_path / "cache"), "--export-png", str(png),
    )
    assert r.returncode == 0, r.stderr
    assert "257x257" in r.stdout
    assert png.exists()
    assert list((tmp_path / "cache").glob("*.smhhm"))

    # Second run hits the cache (ripper wrapper removed to prove it).
    wrapper.unlink()
    r2 = run_cli(
        "--rip", "SquadGame/Content/Maps/Mutaha/Mutaha.umap",
        "--paks", "paks", "--ripper", str(tmp_path / "gone.sh"),
        "--cache-dir", str(tmp_path / "cache"),
    )
    assert r2.returncode == 0, r2.stderr


def test_cli_video_source(tmp_path):
    """--video feeds a recording through the full app (headless web off)."""
    import pytest

    cv2 = pytest.importorskip("cv2")
    import numpy as np

    sys.path.insert(0, str(REPO))
    from smh_tpu import testing

    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (1280, 720))
    assert writer.isOpened()
    for i in range(3):
        f = testing.make_frame(1280, 720, marker_lines=[((100 + i, 100), (420, 300))])
        writer.write(np.ascontiguousarray(f[..., :3]))
    writer.release()

    proc = subprocess.Popen(
        [sys.executable, "-m", "smh_tpu.app", "--video", path, "--no-web",
         "--backend", "numpy", "--settings", str(tmp_path / "s.json")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": "/root",
             "PYTHONPATH": str(REPO)},
    )
    time.sleep(10)
    proc.send_signal(signal.SIGINT)
    out, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert "error processing frame" not in err


def test_cli_screen_source_fails_cleanly_headless(tmp_path):
    import pytest

    try:
        r = run_cli("--screen", "--no-web", "--backend", "numpy",
                    "--settings", str(tmp_path / "s.json"), timeout=60)
    except subprocess.TimeoutExpired:
        pytest.skip("a display is available: --screen started successfully")
    assert r.returncode != 0
    assert "screen capture" in (r.stderr + r.stdout)


def test_analyze_video_main_stream(tmp_path, monkeypatch, capsys):
    """Drive tools/analyze_video.py's main() end-to-end over a synthesized
    recording (in-process: the CPU test platform must be inherited — a
    subprocess would initialize the accelerator backend)."""
    import pytest

    cv2 = pytest.importorskip("cv2")
    import numpy as np

    from smh_tpu import testing

    w, h = 1280, 720
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
    assert writer.isOpened()
    for i in range(5):
        bgra = testing.make_frame(
            w, h, marker_lines=[((100 + 5 * i, 100), (420, 300))],
            scale_bars=[(60, 200, 120, 1)],
        )
        writer.write(np.ascontiguousarray(bgra[..., :3]))
    writer.release()

    import importlib
    import json as _json
    import sys as _sys

    root = pathlib.Path(__file__).resolve().parent.parent
    _sys.path.insert(0, str(root / "tools"))
    try:
        av = importlib.import_module("analyze_video")
        monkeypatch.setattr(
            _sys, "argv",
            ["analyze_video.py", path, "--batch", "2", "--ocr", "none", "--limit", "4"],
        )
        rc = av.main()
    finally:
        _sys.path.remove(str(root / "tools"))
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    rows = [_json.loads(l) for l in out]
    assert len(rows) == 4
    assert all(not r["sleeping"] and r["markers"] for r in rows)
