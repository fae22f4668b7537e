"""Soak: every distinct sample resolution through the full driver on the
device backend (CPU platform) — resize/re-bucket robustness."""

import pytest

from conftest import REFERENCE_SAMPLES, reference_samples_available
from smh_tpu.ocr.smhocr import SmhOcrEngine
from smh_tpu.settings import Settings
from smh_tpu.squadex.capture import Frame, load_frame_bgra
from smh_tpu.vision.pipeline import VisionState

pytestmark = [
    pytest.mark.skipif(
        not reference_samples_available(), reason="reference samples not mounted"
    ),
    pytest.mark.slow,  # jit-compile heavy (see pyproject markers)
]

# One sample per distinct resolution in the corpus.
SAMPLES = [
    "point.png",  # 2560x1440
    "full_1024x768.png",
    "full_1280x1024.png",
    "full_1600x1024.png",
]


def test_resolution_sweep_single_state():
    """ONE VisionState must survive resolution changes mid-stream (the
    reference reallocates buffers on resize; we re-bucket jits)."""
    settings = Settings(path=None)
    settings.set("hardware_acceleration", True)
    state = VisionState(settings=settings, ocr_engine=SmhOcrEngine())
    seen = []
    for name in SAMPLES + SAMPLES[:2]:  # revisit earlier buckets too
        frame = load_frame_bgra(str(REFERENCE_SAMPLES / name))
        res = state.process(Frame(frame, 96))
        seen.append((name, None if res is None else len(res.markers)))
    state.close()
    # point.png detects its marker line in every visit
    assert all(n == 1 for s, n in seen if s == "point.png"), seen
    # no crashes and every frame produced a verdict (None == sleeping is fine)
    assert len(seen) == len(SAMPLES) + 2
