"""4K stress corpus: real screenshots, upscaled, with pinned oracle goldens.

The reference ships no 4K captures, so the 4K set is nearest-upscaled from
vision-common/samples (provenance recorded in the goldens; every pixel is an
exact original game color — smh_tpu.testing.upscale_frame). This pins 4K
behaviour on REAL content: dense masks (snowpoints: 24 lines, full.jpg: 28)
exercise the sparse word budget where synthetic bench frames stay tiny, and
difficult/whiteout pin the adversarial cases at the resolution the perf
numbers are quoted at. Regenerate with tools/gen_goldens_extra.py."""

import json
import math
import pathlib

import pytest

from conftest import REFERENCE_SAMPLES, reference_samples_available

GOLDEN_PATH = pathlib.Path(__file__).parent / "goldens" / "detections_4k.json"

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        not reference_samples_available(), reason="reference samples not mounted"
    ),
]

GOLDENS = json.loads(GOLDEN_PATH.read_text()) if GOLDEN_PATH.exists() else {}


def load_4k(name):
    from smh_tpu import testing
    from smh_tpu.squadex.capture import load_frame_bgra

    return testing.upscale_frame(
        load_frame_bgra(str(REFERENCE_SAMPLES / name)), 3840, 2160
    )


# Oracle regression on a subset (the full oracle sweep at 4K is minutes of
# numpy; the device sweep below covers every sample against the same goldens).
ORACLE_4K = ["points.png", "difficult.png", "whiteout.png"]


@pytest.mark.parametrize("name", ORACLE_4K)
def test_oracle_4k_matches_golden(name):
    from smh_tpu.vision.reference import ReferenceBackend

    golden = GOLDENS[name]
    be = ReferenceBackend()
    be.load_frame(load_4k(name))
    cropped = be.crop_to_map(grayscale=True)
    assert (cropped is None) == golden["sleeping"]
    if golden["sleeping"]:
        return
    be.isolate_map_markers()
    be.mask_marker_lines()
    lines = be.find_marker_lines(15)
    got = [
        [round(l.p0.x, 3), round(l.p0.y, 3), round(l.p1.x, 3), round(l.p1.y, 3)]
        for l in lines
    ]
    assert got == golden["lines"]


def test_tpu_4k_full_corpus_matches_goldens():
    """Every 4K sample through the device backend, one instance (the sparse
    rung ladder adapts across the dense frames exactly as a session would).
    Dense masks may overflow the sparse budget — that must surface as the
    full-mask fallback (correct detections + a counted miss), never as
    wrong lines."""
    from smh_tpu.vision.tpu_backend import TpuBackend

    be = TpuBackend()
    mismatches = []
    for name, golden in sorted(GOLDENS.items()):
        be.load_frame(load_4k(name))
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
                math.hypot(l.p0.x - e[0], l.p0.y - e[1]) > 1.5
                or math.hypot(l.p1.x - e[2], l.p1.y - e[3]) > 1.5
            ):
                mismatches.append((name, f"line off: {l} vs {e}"))
                break
    assert not mismatches, mismatches
    # The detections above must hold whether or not the dense frames
    # overflowed the sparse budget; surface the counters so a regression in
    # the fallback machinery is visible in the test log.
    print("sparse stats:", {k: v for k, v in be.stats.items() if "sparse" in k})
