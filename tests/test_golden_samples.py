"""Golden tests over the reference's real sample corpus.

The goldens (tests/goldens/detections.json) were produced by the numpy
oracle; these tests pin the oracle (exact regression) and diff the device
backend against it on real game screenshots — the automated cross-backend
consistency test the reference lacked (SURVEY.md section 4).

Skipped when the read-only reference checkout is absent.
"""

import json
import math
import pathlib

import pytest

from conftest import REFERENCE_SAMPLES, reference_samples_available

GOLDENS = json.loads(
    (pathlib.Path(__file__).parent / "goldens" / "detections.json").read_text()
)

pytestmark = pytest.mark.skipif(
    not reference_samples_available(), reason="reference samples not mounted"
)

# Samples that exercise distinct behaviours, kept fast enough for CI.
ORACLE_SAMPLES = [
    "point.png",
    "point_intersect.png",
    "points.png",
    "full_1024x768.png",  # sleeping=False, no lines
    "fullmapgreen.jpg",
    "in_mortar.png",
    "tinyscales.png",
]
TPU_SAMPLES = [
    "point.png",
    "point_intersect.png",
    "in_mortar.png",
    "points.png",
    "full_1600x1024.png",
    "lol.png",
]


def run_oracle(name):
    from smh_tpu.squadex.capture import load_frame_bgra
    from smh_tpu.vision.reference import ReferenceBackend

    frame = load_frame_bgra(str(REFERENCE_SAMPLES / name))
    be = ReferenceBackend()
    be.load_frame(frame)
    cropped = be.crop_to_map(grayscale=True)
    if cropped is None:
        return None
    be.isolate_map_markers()
    be.mask_marker_lines()
    return be.find_marker_lines(15)


@pytest.mark.parametrize("name", ORACLE_SAMPLES)
def test_oracle_matches_golden(name):
    golden = GOLDENS[name]
    lines = run_oracle(name)
    if golden["sleeping"]:
        assert lines is None
        return
    assert lines is not None
    got = [
        [round(l.p0.x, 3), round(l.p0.y, 3), round(l.p1.x, 3), round(l.p1.y, 3)]
        for l in lines
    ]
    assert got == golden["lines"]


@pytest.mark.parametrize("name", TPU_SAMPLES)
def test_tpu_matches_golden_detections(name):
    from smh_tpu.squadex.capture import load_frame_bgra
    from smh_tpu.vision.tpu_backend import TpuBackend

    golden = GOLDENS[name]
    assert not golden["sleeping"]

    frame = load_frame_bgra(str(REFERENCE_SAMPLES / name))
    be = TpuBackend()
    be.load_frame(frame)
    assert be.crop_to_map(grayscale=True) is not None
    lines = be.find_marker_lines(15)

    expected = golden["lines"]
    assert len(lines) == len(expected), (lines, expected)
    for l, e in zip(lines, expected):
        assert math.hypot(l.p0.x - e[0], l.p0.y - e[1]) <= 1.5
        assert math.hypot(l.p1.x - e[2], l.p1.y - e[3]) <= 1.5


@pytest.mark.slow
def test_tpu_full_corpus_matches_goldens():
    """EVERY pinned sample through the device backend (the CI twin of
    tools/soak_corpus.py — round 3 only spot-checked 6 of the 26 in CI, so
    a regression could hide in the unselected samples). One backend
    instance across the corpus also exercises resolution switches, ladder
    resets and the delta-chain restart on geometry changes."""
    import math as _math

    from smh_tpu.squadex.capture import load_frame_bgra
    from smh_tpu.vision.tpu_backend import TpuBackend

    be = TpuBackend()
    mismatches = []
    for name, golden in sorted(GOLDENS.items()):
        frame = load_frame_bgra(str(REFERENCE_SAMPLES / name))
        be.load_frame(frame)
        cropped = be.crop_to_map(grayscale=True)
        if golden["sleeping"]:
            if cropped is not None:
                mismatches.append((name, "expected sleeping"))
            continue
        if cropped is None:
            mismatches.append((name, "unexpectedly sleeping"))
            continue
        lines = be.find_marker_lines(15)
        expected = golden["lines"]
        if len(lines) != len(expected):
            mismatches.append((name, f"{len(lines)} lines != {len(expected)}"))
            continue
        for l, e in zip(lines, expected):
            if (
                _math.hypot(l.p0.x - e[0], l.p0.y - e[1]) > 1.5
                or _math.hypot(l.p1.x - e[2], l.p1.y - e[3]) > 1.5
            ):
                mismatches.append((name, f"line off: {l} vs {e}"))
                break
    assert not mismatches, mismatches


# Real 2560x1440 game screenshots through the BATCH pipeline (the throughput
# mode): detections must match the same per-frame goldens. Covers the batch
# hostpack, the sparse mask sections, the per-frame red gate (one frame with
# the close-button blacked out must come back sleeping), batch padding
# (batch > len(frames)), and the bbox-sliced host stages on real content.
BATCH_SAMPLES = ["points.png", "point_far.png", "glorious.png", "in_mortar.png"]


@pytest.mark.slow
def test_batch_pipeline_matches_goldens():
    import numpy as np

    from smh_tpu import consts as C_
    from smh_tpu.squadex.capture import load_frame_bgra
    from smh_tpu.vision.batch import BatchPipeline

    frames = [
        load_frame_bgra(str(REFERENCE_SAMPLES / n)) for n in BATCH_SAMPLES
    ]
    h, w = frames[0].shape[:2]
    assert all(f.shape[:2] == (h, w) for f in frames)
    # A sleeping frame at the corpus resolution: black out the close-button
    # region so the red gate fails (the real sleeping samples are other
    # resolutions; the gate itself is what matters).
    sleeper = frames[0].copy()
    g = C_.map_geometry(w, h)
    sleeper[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w] = np.uint8(0)
    bp = BatchPipeline(w, h, batch=len(frames) + 2, ocr_engine=None)
    assert bp.sparse_budget is not None  # real-res corpus: sparse active
    results = bp.process(frames + [sleeper])  # 5 frames in a 6-batch: padding
    bp.close()
    assert len(results) == len(frames) + 1
    assert results[-1].sleeping and not results[-1].markers
    for name, res in zip(BATCH_SAMPLES, results):
        golden = GOLDENS[name]
        assert not res.sleeping and not golden["sleeping"], name
        expected = golden["lines"]
        assert len(res.markers) == len(expected), (name, res.markers, expected)
        for l, e in zip(res.markers, expected):
            assert math.hypot(l.p0.x - e[0], l.p0.y - e[1]) <= 1.5, name
            assert math.hypot(l.p1.x - e[2], l.p1.y - e[3]) <= 1.5, name
        if golden.get("minimap") and res.minimap_bounds is not None:
            ml, mt, mr, mb = golden["minimap"]
            bmap = res.minimap_bounds
            assert (bmap.left, bmap.top, bmap.right, bmap.bottom) == (ml, mt, mr, mb), name
