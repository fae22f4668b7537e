"""Failure detection / recovery (SURVEY.md section 5): device failures
surface, per-frame error isolation, loop pause/resume."""

import time

import numpy as np
import pytest

from smh_tpu import testing
from smh_tpu.ocr import FakeOcrEngine
from smh_tpu.settings import Settings
from smh_tpu.squadex.capture import CaptureThread, Frame, StaticSource
from smh_tpu.vision.pipeline import VisionLoop, VisionState


def test_tpu_failure_falls_back_to_numpy(monkeypatch):
    """A device-backend crash mid-frame surfaces to the caller and the
    device backend stays selected: no silent swap to the numpy oracle (the
    live loop drops such a frame and logs it, see the test below)."""
    from smh_tpu.vision import tpu_backend

    def boom(self, grayscale):
        raise RuntimeError("synthetic device failure")

    monkeypatch.setattr(tpu_backend.TpuBackend, "crop_to_map", boom)

    settings = Settings(path=None)
    settings.set("hardware_acceleration", True)
    state = VisionState(settings=settings, ocr_engine=FakeOcrEngine([]))
    frame = Frame(testing.make_frame(1280, 720, marker_lines=[((100, 100), (420, 300))]))

    for _ in range(2):  # every frame: no flapping to another backend
        with pytest.raises(RuntimeError, match="synthetic device failure"):
            state.process(frame)
        assert state.delegate.backend.name == "tpu"

    # The user's hardware_acceleration toggle still selects the oracle.
    settings.set("hardware_acceleration", False)
    res = state.process(frame)
    assert res is not None and len(res.markers) == 1
    assert state.delegate.backend.name == "numpy"
    state.close()


def test_device_backend_refuses_implicit_cpu():
    """XLA:CPU runs the device backend only when jax_platforms names the
    CPU explicitly; a host whose accelerator is missing fails loudly."""
    import jax

    from smh_tpu.vision.tpu_backend import TpuBackend

    assert jax.devices()[0].platform == "cpu"
    TpuBackend()  # conftest names "cpu" explicitly
    jax.config.update("jax_platforms", "")
    try:
        with pytest.raises(RuntimeError, match="no accelerator"):
            TpuBackend()
    finally:
        jax.config.update("jax_platforms", "cpu")


def test_loop_pause_resume_and_error_isolation():
    settings = Settings(path=None)
    settings.set("hardware_acceleration", False)
    state = VisionState(settings=settings, ocr_engine=FakeOcrEngine([]))

    frames = [
        testing.make_frame(640, 360, marker_lines=[((50, 50), (200, 150))]),
        testing.make_frame(640, 360, marker_lines=[((60, 60), (210, 160))]),
    ]
    idx = {"i": 0}

    class Cycle:
        def grab(self):
            idx["i"] += 1
            return Frame(frames[idx["i"] % 2])

    updates = []
    cap = CaptureThread(Cycle(), hz=60).start()
    loop = VisionLoop(state, cap, lambda r, d: updates.append(r), fps=60).start()
    try:
        deadline = time.time() + 20
        while len(updates) < 3 and time.time() < deadline:
            time.sleep(0.05)
        assert len(updates) >= 3

        # Pause stops production.
        settings.set_paused(True)
        time.sleep(0.3)
        n = len(updates)
        time.sleep(0.5)
        assert len(updates) == n

        # Resume restarts it.
        settings.set_paused(False)
        deadline = time.time() + 20
        while len(updates) <= n and time.time() < deadline:
            time.sleep(0.05)
        assert len(updates) > n

        # A poisoned frame is dropped, the loop survives (vision/mod.rs:271-277).
        loop.fake_input = np.zeros((10, 10, 4), dtype=np.uint8)  # degenerate size
        time.sleep(0.4)
        loop.fake_input = None
        deadline = time.time() + 20
        n = len(updates)
        while len(updates) <= n and time.time() < deadline:
            time.sleep(0.05)
        assert len(updates) > n  # still alive after the bad frame
    finally:
        loop.stop()
        cap.stop()
