"""Hostpack v2: windowed LSD crop, checksum-gated scales, async branch.

The round-2 payload redesign must be behaviour-preserving: crop-local
detection == full-mask detection (exactly — the window carries enough black
margin that rays/snaps can't tell the difference), window misses fall back to
the full mask, and the scales branch fetches pixels only when the device
checksum changed."""

import os

import numpy as np
import pytest

from smh_tpu import consts as C, testing
from smh_tpu.ocr import FakeOcrEngine, OcrResult
from smh_tpu.settings import Settings
from smh_tpu.squadex.capture import Frame
from smh_tpu.vision.pipeline import VisionState
from smh_tpu.vision.tpu_backend import TpuBackend

pytestmark = pytest.mark.slow  # jit-compile heavy (see pyproject markers)

W, H = 1920, 1080  # map mask > 16 KiB: windowing active


@pytest.fixture(autouse=True)
def _window_transport(monkeypatch):
    """This module tests the WINDOW-crop transport (the SMH_SPARSE=0 path);
    the sparse-word transport that replaced it as the default has its own
    module, tests/test_sparse_transport.py."""
    monkeypatch.setenv("SMH_SPARSE", "0")


def small_lines_frame(off=0):
    return testing.make_frame(
        W, H,
        marker_lines=[((120 + off, 150), (380 + off, 320))],
        scale_bars=[(60, 200, 120, 1)],
    )


def spanning_lines_frame():
    g = C.map_geometry(W, H)
    return testing.make_frame(
        W, H,
        marker_lines=[
            ((20, 20), (g.map_w - 30, g.map_h - 40)),
            ((g.map_w - 50, 40), (30, g.map_h - 60)),
        ],
        scale_bars=[(60, 200, 120, 1)],
    )


def detect(be: TpuBackend, frame) -> list:
    be.load_frame(frame)
    assert be.crop_to_map(True) is not None
    be.mask_marker_lines()
    return be.find_marker_lines(C.LSD_MAX_GAP)


def lines_tuples(lines):
    return [((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in lines]


def force_full(be: TpuBackend):
    """A backend pinned to the full-mask window (= round-1 behaviour)."""
    be.load_frame(small_lines_frame())  # init geom
    from smh_tpu.vision import tpu_backend as tb

    be._ladder_h = tb._dim_ladder(be.geom.map_h)
    be._ladder_w = tb._dim_ladder(be.geom.map_w)
    be._rung_h = len(be._ladder_h) - 1
    be._rung_w = len(be._ladder_w) - 1
    return be


def test_windowed_crop_equals_full_mask_detection():
    from smh_tpu.vision.tpu_backend import _RUNG_HALF

    frame = small_lines_frame()
    be_win = TpuBackend()
    be_win._rung_h = be_win._rung_w = _RUNG_HALF  # half window: the line fits
    lines_win = detect(be_win, frame)
    assert be_win.stats["lsd_window_misses"] == 0
    assert be_win._host["lsd_crop_shape"] != (be_win.geom.map_h, be_win.geom.map_w)

    be_full = force_full(TpuBackend())
    lines_full = detect(be_full, frame)

    assert lines_tuples(lines_win) == lines_tuples(lines_full)
    assert len(lines_win) == 1


def test_window_miss_falls_back_and_escalates():
    frame = spanning_lines_frame()
    be = TpuBackend()
    be._rung_h = be._rung_w = 0  # smallest window: spanning lines cannot fit
    lines = detect(be, frame)
    assert be.stats["lsd_window_misses"] == 1
    assert be._rung_h > 0 and be._rung_w > 0  # escalated for the next frame

    be_full = force_full(TpuBackend())
    lines_full = detect(be_full, frame)
    assert lines_tuples(lines) == lines_tuples(lines_full)
    assert len(lines) == 2


def test_empty_mask_detects_nothing_and_shrinks_payload():
    frame = testing.make_frame(W, H, marker_lines=[], scale_bars=[(60, 200, 120, 1)])
    be = TpuBackend()
    lines = detect(be, frame)
    assert lines == []
    y0, y1, x0, x1 = be._host["lsd_bbox"]
    assert y0 >= y1  # device reported an empty bbox


def test_scales_transport_adapts_inline_to_checksum_only():
    """Lifecycle of the adaptive scales transport: images ride inline in the
    single hostpack fetch while changing (no separate scalespack fetch);
    after _INLINE_STABLE_AFTER unchanged checksums they drop out of the pack
    (checksum-only, ratio from cache); a change then costs ONE lazy
    scalespack fetch and flips inline back on."""
    from smh_tpu.vision import tpu_backend as tb

    ocr = FakeOcrEngine([OcrResult("300m", 91.0, 100, 180, 140, 195)])
    state = VisionState(settings=Settings(path=None), ocr_engine=ocr)
    state.settings.set("hardware_acceleration", True)

    r1 = state.process(Frame(small_lines_frame(0), 96))
    be = state.delegate.backend
    assert isinstance(be, TpuBackend)
    assert r1 is not None and r1.meters_to_px_ratio is not None
    # FakeOcrEngine is binary_ok: the OCR section travels as a bit mask.
    assert be._dispatch_flags[5] == "binary"
    assert be.stats["scalespack_fetches"] == 0  # inline: no separate fetch

    # Same BRQ content (marker moved in the top-left of the map only):
    # checksum unchanged -> ratio from cache; after the stability streak the
    # pack drops the inline sections.
    for off in range(1, tb._INLINE_STABLE_AFTER + 2):
        r = state.process(Frame(small_lines_frame(off), 96))
        assert r is not None and r.meters_to_px_ratio == r1.meters_to_px_ratio
    assert be._dispatch_flags[5] == "none"  # checksum-only transport now
    assert be.stats["scalespack_fetches"] == 0  # still zero D2H for scales

    # Perturb the BRQ -> checksum changes -> one lazy scalespack fetch, and
    # the transport flips back to inline for the next frame.
    f3 = small_lines_frame(1)
    g = C.map_geometry(W, H)
    f3[g.brq_y + 300 : g.brq_y + 310, g.brq_x + 300 : g.brq_x + 340, :3] = 255
    r3 = state.process(Frame(f3, 96))
    assert r3 is not None and r3.meters_to_px_ratio == r1.meters_to_px_ratio
    assert be.stats["scalespack_fetches"] == 1
    state.process(Frame(small_lines_frame(2), 96))
    assert be._dispatch_flags[5] == "binary"
    state.close()


def test_async_scales_publishes_markers_immediately_then_ratio():
    ocr = FakeOcrEngine([OcrResult("300m", 91.0, 100, 180, 140, 195)])
    state = VisionState(
        settings=Settings(path=None), ocr_engine=ocr, scales_async=True
    )
    state.settings.set("hardware_acceleration", True)

    r1 = state.process(Frame(small_lines_frame(0), 96))
    assert r1 is not None and len(r1.markers) == 1
    # Ratio may lag by a frame; feeding identical frames must converge.
    ratio = r1.meters_to_px_ratio
    for _ in range(20):
        if ratio is not None:
            break
        import time

        time.sleep(0.02)
        r = state.process(Frame(small_lines_frame(0), 96))
        assert r is not None
        ratio = r.meters_to_px_ratio
    assert ratio == pytest.approx(300.0 / 118.0)
    state.close()


def test_rung_shrinks_after_streak():
    from smh_tpu.vision import tpu_backend as tb

    be = TpuBackend()
    frame = small_lines_frame()
    start = tb._RUNG_HALF + 1  # oversized (3/4) window for this bbox
    be._rung_h = be._rung_w = start
    detect(be, frame)
    assert (be._rung_h, be._rung_w) == (start, start)  # no immediate shrink
    for _ in range(tb._SHRINK_AFTER):
        be.dispatch()
        be.crop_to_map(True)
    # one rung at a time after a sustained streak, per dimension
    assert be._rung_h == start - 1 and be._rung_w <= start


def test_binary_ocr_threshold_matches_smhocr():
    """The device bit-packs `ocr_img < OCR_BINARY_THRESHOLD`; smhocr
    thresholds with TEXT_THRESHOLD. They must agree or binary transport
    would not be exact for it."""
    from smh_tpu.ocr import smhocr
    from smh_tpu.ops import pipeline as ops_pipeline

    assert ops_pipeline.OCR_BINARY_THRESHOLD == smhocr.TEXT_THRESHOLD


def test_binary_transport_reads_identically_with_smhocr():
    """smhocr over the reconstructed 0/255 image == smhocr over the true
    grayscale OCR image (it only thresholds)."""
    pytest.importorskip("scipy")
    from smh_tpu.ocr.smhocr import SmhOcrEngine
    from smh_tpu.vision.reference import ReferenceBackend

    frame = testing.make_frame(
        W, H, scale_bars=[(60, 200, 120, 1)], scale_texts=[("300m", (80, 170))]
    ) if "scale_texts" in testing.make_frame.__code__.co_varnames else None
    if frame is None:
        # testing.make_frame has no text renderer: use a real corpus sample.
        import pathlib

        sample = pathlib.Path("/root/reference/vision-common/samples/full.jpg")
        if not sample.is_file():
            pytest.skip("no corpus available")
        from smh_tpu.squadex.capture import load_frame_bgra

        frame = load_frame_bgra(str(sample))

    ref = ReferenceBackend()
    ref.load_frame(frame)
    if ref.crop_to_map(True) is None:
        pytest.skip("sample sleeping")
    gray = ref.ocr_preprocess()

    import numpy as np

    from smh_tpu.ops import pipeline as ops_pipeline

    binary = np.where(gray < ops_pipeline.OCR_BINARY_THRESHOLD, np.uint8(0), np.uint8(255))
    eng = SmhOcrEngine()
    a = eng.read(gray)
    b = eng.read(binary)
    assert [(r.text, r.left, r.top, r.right, r.bottom) for r in a] == [
        (r.text, r.left, r.top, r.right, r.bottom) for r in b
    ]
    assert a, "sample must contain readable text for this test to mean anything"


def test_contract_march_methods_work_without_mask_output():
    """Production dispatch (native engine) drops the device mask output;
    the backend-contract march methods must rebuild it on device instead of
    KeyError-ing (round-2 review finding)."""
    from smh_tpu.geometry import Point

    be = TpuBackend()
    if be.lsd_engine != "native":
        pytest.skip("native engine unavailable")
    frame = small_lines_frame()
    be.load_frame(frame)
    assert be.crop_to_map(True) is not None
    assert "lsd_mask" not in be._results  # production config drops it
    line, len_sqr = be.find_longest_line(None, Point(121.0, 151.0), 15.0)
    assert len_sqr > 2500  # the drawn marker line is found
    assert "lsd_mask" in be._results  # rebuilt on device and cached


# ---- OCR text-row band transport (real engine; smhocr derives from pixels) --


def textful_frame(off=0, extra_text=()):
    return testing.make_frame(
        W, H,
        marker_lines=[((120 + off, 150), (380 + off, 320))],
        scale_texts=[("300m", (60, 170))] + list(extra_text),
        scale_bars=[(60, 200, 120, 1)],
    )


def smhocr_state(device_scales: bool = False):
    """A device-backed state with the real smhocr engine. The band-transport
    tests below exercise the image path, so the on-device scales reader
    (which would supersede the band entirely) is disabled by default."""
    pytest.importorskip("scipy")
    from smh_tpu.ocr.smhocr import SmhOcrEngine

    engine = SmhOcrEngine()
    if not device_scales:
        engine.device_ok = False  # instance shadow of the class attr
    state = VisionState(settings=Settings(path=None), ocr_engine=engine)
    state.settings.set("hardware_acceleration", True)
    return state


def test_scales_band_transport_exact_with_real_engine():
    state = smhocr_state()
    r = state.process(Frame(textful_frame(), 96))
    be = state.delegate.backend
    assert r is not None
    assert r.meters_to_px_ratio == pytest.approx(300.0 / 118.0)
    # band transport was active and sufficient: no fallback fetch
    assert be._dispatch_flags[6] is not None  # a band was packed
    assert isinstance(be._host["scales_band"], tuple)
    assert be.stats["scales_band_misses"] == 0
    assert be.stats["scalespack_fetches"] == 0

    # full-transport reference: same frame through a band-less backend
    # (engine flagged non-image-derived keeps full-height inline sections)
    state2 = smhocr_state()
    state2.ocr_engine.image_derived = False
    r2 = state2.process(Frame(textful_frame(), 96))
    assert state2.delegate.backend._dispatch_flags[6] is None  # no band
    assert r2 is not None and r2.meters_to_px_ratio == r.meters_to_px_ratio
    state.close()
    state2.close()


def test_scales_band_miss_falls_back_and_escalates():
    state = smhocr_state()
    # Text at the very top AND bottom of the BRQ: no quarter/half band fits.
    g = C.map_geometry(W, H)
    frame2 = testing.make_frame(
        W, H,
        marker_lines=[((120, 150), (380, 320))],
        scale_texts=[("300m", (60, 170)), ("900m", (400, g.brq_h - 60))],
        scale_bars=[(60, 200, 120, 1)],
    )
    r = state.process(Frame(frame2, 96))
    be = state.delegate.backend
    assert r is not None
    # the band (started at 1/2 brq) cannot cover top..bottom text: fallback
    assert be.stats["scales_band_misses"] >= 1
    assert be.stats["scalespack_fetches"] >= 1
    assert be._band_rung > 1  # escalated
    # ratio still correct (from the full-resolution fallback): 300/118
    # averaged with whatever the 900m text resolves to (it has no bar -> no
    # contribution), so exactly 300/118.
    assert r.meters_to_px_ratio == pytest.approx(300.0 / 118.0)
    state.close()


def test_scales_band_textless_is_exact_and_fetch_free():
    state = smhocr_state()
    frame = testing.make_frame(W, H, marker_lines=[((120, 150), (380, 320))])
    r = state.process(Frame(frame, 96))
    be = state.delegate.backend
    assert r is not None and r.meters_to_px_ratio is None
    band = be._host["scales_band"]
    assert isinstance(band, tuple) and band[2] is True  # textless
    assert be.stats["scalespack_fetches"] == 0
    state.close()


def test_fake_engine_disables_band_transport():
    ocr = FakeOcrEngine([OcrResult("300m", 91.0, 100, 180, 140, 195)])
    state = VisionState(settings=Settings(path=None), ocr_engine=ocr)
    state.settings.set("hardware_acceleration", True)
    r = state.process(Frame(small_lines_frame(), 96))
    be = state.delegate.backend
    assert r is not None and r.meters_to_px_ratio is not None
    assert be._dispatch_flags[6] is None  # no band: canned bboxes roam free
    state.close()


def test_bbox_crop_host_right_edge_stays_within_plane():
    """Mask pixels near the right edge of a non-byte-aligned plane: the
    byte-aligned crop must be trimmed to the logical width (a crop
    overhanging the plane breaks canvas-paste consumers; review round 3)."""
    import numpy as np

    from smh_tpu.ops import pipeline as ops_pipeline

    ch, cw = 60, 493  # non-multiple of 8, like real map widths
    mask = np.zeros((ch, cw), dtype=np.uint8)
    mask[20:40, cw - 6 : cw] = 1  # content 6 px from the right edge
    bits = np.packbits(mask, axis=1)
    bbox = (20, 40, cw - 6, cw)  # absolute, end-exclusive; origin (0, 0)
    crop, (ox, oy) = ops_pipeline.bbox_crop_host(bits, bbox, (0, 0), (ch, cw))
    assert ox + crop.shape[1] <= cw and oy + crop.shape[0] <= ch
    # Crop content equals the same slice of the full unpack.
    full = np.unpackbits(bits, axis=1)[:, :cw] * np.uint8(255)
    ref = full[oy : oy + crop.shape[0], ox : ox + crop.shape[1]]
    assert np.array_equal(crop, ref)
    # All mask pixels are inside the crop with margin context.
    assert crop.any()
