"""Device-side scale reading (ops/scales_device): glyph records, bar scans,
and the decoded ratio must agree with the host engine + host bar walk."""

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import REFERENCE_SAMPLES, reference_samples_available
from smh_tpu import consts as C, testing
from smh_tpu.ocr.smhocr import SmhOcrEngine
from smh_tpu.ops import scales_device as sd
from smh_tpu.vision import mpx_ratio as mpx
from smh_tpu.vision import pixmath as pm
from smh_tpu.vision.pipeline import _parse_scales

import jax

pytestmark = pytest.mark.slow  # jit-compile heavy (see pyproject markers)


def _device_read(ocr_img: np.ndarray, scales_img: np.ndarray) -> sd.DeviceScales:
    text = jnp.asarray(ocr_img < sd.OCR_BINARY_THRESHOLD)
    sbool = jnp.asarray(scales_img != 0)
    tpl = jnp.asarray(sd.device_templates())
    rec = np.asarray(jax.jit(sd.scales_records)(text, sbool, tpl))
    return sd.decode_records(rec)


def _brq_planes(frame: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    h, w = frame.shape[:2]
    g = C.map_geometry(w, h)
    map_bgra = frame[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
    brq = map_bgra[g.map_h // 2 :, g.map_w // 2 :][: g.brq_h, : g.brq_w]
    brq_rgb = brq[..., [2, 1, 0]]
    return pm.ocr_preprocess(brq_rgb), pm.find_scales_binarize(brq_rgb)


def test_synthetic_words_and_ratio_match_host():
    frame = testing.make_frame(
        1920, 1080,
        marker_lines=[((120, 150), (700, 520))],
        scale_texts=[("300m", (60, 170)), ("900m", (260, 170))],
        scale_bars=[(60, 200, 118, 1), (260, 200, 118, 1)],
    )
    ocr_img, sbin = _brq_planes(frame)

    host_words = SmhOcrEngine().read(ocr_img)
    scales, _sy = _parse_scales(host_words)
    host_ratio = mpx.calc_meters_to_px_ratio(scales, sbin)

    dev = _device_read(ocr_img, sbin)
    assert dev.ok, f"unexpected overflow flags {dev.flags}"
    assert [(w.text, w.left, w.top, w.right, w.bottom) for w in dev.words] == [
        (w.text, w.left, w.top, w.right, w.bottom) for w in host_words
    ]
    assert sd.ratio_from_records(dev) == pytest.approx(host_ratio, rel=1e-9)


@pytest.mark.parametrize("text,expected", [("600m", 600), ("900m", 900), ("150m", 150), ("1200m", 1200)])
def test_digit_discrimination_device(text, expected):
    from test_smhocr import render_text_frame

    ocr_img, sbin = _brq_planes(render_text_frame(text=text))
    dev = _device_read(ocr_img, sbin)
    assert dev.ok
    parsed = [w.text for w in dev.words if w.text.endswith("m") and w.text[:-1].isdigit()]
    assert parsed == [text], [w.text for w in dev.words]


def test_garbage_parses_nothing():
    rng = np.random.default_rng(0)
    noise = np.where(rng.random((200, 300)) > 0.995, np.uint8(0), np.uint8(255))
    sbin = np.full((200, 300), 255, np.uint8)
    dev = _device_read(noise, sbin)
    if dev.ok:  # specks may overflow the slots -> fallback; if not, no scales
        assert sd.ratio_from_records(dev) is None


def test_overflow_sets_flags():
    """More text-row bands than slots must flag the fallback, not mis-read."""
    img = np.full((400, 300), 255, np.uint8)
    for b in range(sd.MAX_BANDS + 2):  # 8 bands of fat text rows
        img[b * 40 : b * 40 + 10, 50:220] = 0
    dev = _device_read(img, np.full((400, 300), 255, np.uint8))
    assert not dev.complete and (dev.flags & sd.FLAG_BAND_OVERFLOW)


def test_junk_band_keeps_clean_band_trusted():
    """A band with more glyph runs than slots poisons only ITS words; a
    clean '300m' in another band stays trusted and readable."""
    from test_smhocr import render_text_frame

    frame = render_text_frame(text="300m")
    g = C.map_geometry(1280, 720)
    # speckle row far above the text: > MAX_GPB separated 1-px columns
    view = frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w]
    for k in range(sd.MAX_GPB + 4):
        view[40:52, 10 + 6 * k, :3] = 245
    ocr_img, sbin = _brq_planes(frame)
    dev = _device_read(ocr_img, sbin)
    assert not dev.complete  # the speckle band overflowed
    good = [w.text for w, t in zip(dev.words, dev.trusted) if t]
    assert "300m" in good
    assert sd.ratio_from_records(dev) == pytest.approx(300 / 118, rel=1e-6)


def test_full_pipeline_device_transport():
    """End to end through the device backend: the dispatch packs records, the
    scales branch consumes them (no image fetch, no host OCR), and the ratio
    matches the known bar geometry."""
    from smh_tpu.settings import Settings
    from smh_tpu.squadex.capture import Frame
    from smh_tpu.vision.pipeline import VisionState
    from test_smhocr import render_text_frame

    state = VisionState(settings=Settings(path=None), ocr_engine=SmhOcrEngine())
    state.settings.set("hardware_acceleration", True)
    try:
        res = state.process(Frame(render_text_frame(), 96))
        be = state.delegate.backend
        assert res is not None and res.meters_to_px_ratio == pytest.approx(300 / 118)
        assert be._dispatch_flags[5] == "device"
        assert be.stats["device_scales_frames"] == 1
        assert be.stats["device_scales_fallbacks"] == 0
        assert be.stats["scalespack_fetches"] == 0
    finally:
        state.close()


def test_pipeline_falls_back_on_overflow():
    """A frame whose junk overflows every slot still reads via the host
    engine over the lazily fetched scalespack."""
    from smh_tpu.settings import Settings
    from smh_tpu.squadex.capture import Frame
    from smh_tpu.vision.pipeline import VisionState
    from test_smhocr import render_text_frame

    frame = render_text_frame()
    g = C.map_geometry(1280, 720)
    view = frame[g.brq_y : g.brq_y + g.brq_h, g.brq_x : g.brq_x + g.brq_w]
    # > MAX_BANDS whiteish speckle bands above the text AND speckle sharing
    # the text's own band: nothing trusted anywhere
    for b in range(sd.MAX_BANDS + 2):
        for k in range(sd.MAX_GPB + 4):
            view[4 + 14 * b : 12 + 14 * b, 8 + 6 * k, :3] = 245
    state = VisionState(settings=Settings(path=None), ocr_engine=SmhOcrEngine())
    state.settings.set("hardware_acceleration", True)
    try:
        res = state.process(Frame(frame, 96))
        be = state.delegate.backend
        assert res is not None and res.meters_to_px_ratio == pytest.approx(300 / 118)
        assert be._dispatch_flags[5] == "device"
        assert be.stats["device_scales_fallbacks"] == 1
        assert be.stats["scalespack_fetches"] == 1
    finally:
        state.close()


def test_async_scales_consumes_device_records_inline():
    """scales_async=True: the device records ride the snapshot job and are
    consumed inline (no worker, no scalespack fetch)."""
    from smh_tpu.settings import Settings
    from smh_tpu.squadex.capture import Frame
    from smh_tpu.vision.pipeline import VisionState
    from test_smhocr import render_text_frame

    state = VisionState(
        settings=Settings(path=None), ocr_engine=SmhOcrEngine(), scales_async=True
    )
    state.settings.set("hardware_acceleration", True)
    try:
        frame = Frame(render_text_frame(), 96)
        res = state.process(frame)
        assert res is not None
        # Async: the ratio appears by the same frame (records are inline in
        # the hostpack — no fetch latency to hide), or at worst next frame.
        if res.meters_to_px_ratio is None:
            res = state.process(frame)
        assert res.meters_to_px_ratio == pytest.approx(300 / 118)
        be = state.delegate.backend
        assert be.stats["scalespack_fetches"] == 0
        assert state._scales_future is None  # consumed inline, no worker
    finally:
        state.close()


@pytest.mark.skipif(not reference_samples_available(), reason="no reference samples")
def test_corpus_device_reads_match_host():
    """Across the reference screenshot corpus: the device reader parses the
    same scales as the host engine on every sample it reads, with zero false
    positives, and reads at least as many samples as the host floor."""
    import json
    import pathlib

    from smh_tpu.squadex.capture import load_frame_bgra
    from smh_tpu.vision.reference import ReferenceBackend

    goldens = json.loads(
        (pathlib.Path(__file__).parent / "goldens" / "detections.json").read_text()
    )
    eng = SmhOcrEngine()
    tpl = jnp.asarray(sd.device_templates())
    jrec = jax.jit(sd.scales_records)
    read_count = 0
    for name, g in sorted(goldens.items()):
        if g.get("sleeping"):
            continue
        frame = load_frame_bgra(str(REFERENCE_SAMPLES / name))
        be = ReferenceBackend()
        be.load_frame(frame)
        if be.crop_to_map(True) is None:
            continue
        ocr_img = be.ocr_preprocess()
        sbin = be.find_scales_preprocess(0)
        dev = sd.decode_records(
            np.asarray(jrec(
                jnp.asarray(ocr_img < sd.OCR_BINARY_THRESHOLD),
                jnp.asarray(sbin != 0),
                tpl,
            ))
        )
        scales = []
        for w, trust in zip(dev.words, dev.trusted):
            if not trust:
                continue  # junk band overflowed its slots: word untrusted
            m = w.text.rfind("m")
            if m > 0 and w.text[:m].isdigit() and int(w.text[:m]) > 0:
                scales.append(int(w.text[:m]))
        if scales:
            # Never a bogus value; a junk-flagged band may hide one of the
            # two labels (difficult.png), so subset rather than equality.
            assert set(scales) <= {300, 900}, (name, scales)
            read_count += 1
            # the speculative bar scan must agree with the host pixel walk
            host_scales, sy = _parse_scales(eng.read(ocr_img))
            if host_scales:
                host_ratio = mpx.calc_meters_to_px_ratio(host_scales, sbin)
                dev_ratio = sd.ratio_from_records(dev)
                if host_ratio is not None and dev_ratio is not None:
                    assert dev_ratio == pytest.approx(host_ratio, rel=0.02), name
    assert read_count >= 12, read_count
