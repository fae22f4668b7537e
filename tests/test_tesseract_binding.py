"""Exercise the Tesseract ctypes binding for real.

This image ships libtesseract.so.5 but NO traineddata (and no egress to
fetch one), so the real LSTM cannot initialize here. The binding is instead
driven end-to-end against native/libsmhtess.so — an in-repo C
implementation of the same Tesseract C API subset whose Init2 loads the
vendored SMHT traineddata (ocr/tessdata_gen.py) and whose Recognize is a
real C++ glyph recognizer. Every line of ocr/tesseract.py executes: the
traineddata probe, Init2, SetImage stride marshalling, SetSourceResolution,
Recognize, the result/page iterator walk, bounding boxes and
TessDeleteText ownership. Reference counterpart: vision-ocr/src/ocr.cpp:7-55
+ the embedded-traineddata init (vision-ocr/src/lib.rs:129-159).
"""

import numpy as np
import pytest

from conftest import REFERENCE_SAMPLES, reference_samples_available
from smh_tpu.native import tessmock
from smh_tpu.ocr import tesseract as T
from smh_tpu.ocr.tessdata_gen import ensure_default
from smh_tpu.settings import Settings
from smh_tpu.squadex.capture import Frame
from smh_tpu.vision.pipeline import VisionState, _parse_scales


@pytest.fixture(scope="module")
def tess_lib():
    return str(tessmock.lib_path())


@pytest.fixture()
def engine(tess_lib, tmp_path, monkeypatch):
    monkeypatch.setenv("SMH_TESS_LIB", tess_lib)
    ensure_default(tmp_path)  # writes eng.traineddata
    return T.TesseractEngine(tessdata=str(tmp_path))


def test_init_fails_without_traineddata(tess_lib, tmp_path, monkeypatch):
    monkeypatch.setenv("SMH_TESS_LIB", tess_lib)
    with pytest.raises(RuntimeError):
        # empty tessdata dir: the path probe itself raises
        T.TesseractEngine(tessdata=None)
    # present dir but corrupt traineddata: Init2 returns rc != 0
    bad = tmp_path / "eng.traineddata"
    bad.write_bytes(b"not a model")
    with pytest.raises(RuntimeError, match="init failed"):
        T.TesseractEngine(tessdata=str(tmp_path))


def test_available_with_override(tess_lib, tmp_path, monkeypatch):
    monkeypatch.setenv("SMH_TESS_LIB", tess_lib)
    monkeypatch.setenv("TESSDATA_PREFIX", str(tmp_path))
    ensure_default(tmp_path)
    monkeypatch.setattr(T, "_availability", None)
    assert T.available()
    eng = T.create_default_engine()
    assert isinstance(eng, T.TesseractEngine)


def test_reads_rendered_text(engine):
    from tests.test_smhocr import render_text_frame
    from smh_tpu.vision.reference import ReferenceBackend

    be = ReferenceBackend()
    be.load_frame(render_text_frame("300m"))
    assert be.crop_to_map(True) is not None
    results = engine.read(be.ocr_preprocess(), dpi=96)
    texts = [r.text for r in results]
    assert "300m" in texts
    r = results[texts.index("300m")]
    assert r.confidence > 55.0
    # box encloses the rendered label (drawn at x=100, y=172 in BRQ space)
    assert r.left <= 110 and r.right >= 120 and r.top >= 160 and r.bottom <= 200


@pytest.mark.skipif(not reference_samples_available(), reason="no reference samples")
def test_reads_real_scale_labels(engine):
    from smh_tpu.squadex.capture import load_frame_bgra
    from smh_tpu.vision.reference import ReferenceBackend

    frame = load_frame_bgra(str(REFERENCE_SAMPLES / "point.png"))
    be = ReferenceBackend()
    be.load_frame(frame)
    assert be.crop_to_map(True) is not None
    results = engine.read(be.ocr_preprocess())
    texts = {r.text for r in results}
    assert "300m" in texts and "900m" in texts
    scales, _ = _parse_scales(results)
    assert [m for m, _ in scales] == [300, 900]


def test_full_pipeline_with_tesseract_engine(engine):
    """The binding as the pipeline's OCR engine: binary_ok=False forces the
    gray band transport (the non-device engine path)."""
    from tests.test_smhocr import render_text_frame

    settings = Settings(path=None)
    settings.set("hardware_acceleration", False)
    state = VisionState(settings=settings, ocr_engine=engine)
    res = state.process(Frame(render_text_frame()))
    state.close()
    assert res is not None and len(res.markers) == 1
    assert res.meters_to_px_ratio == pytest.approx(300 / 118, rel=1e-6)


def test_threadsafe_reuse(engine):
    """Two sequential reads on one engine (the lock-serialized singleton
    pattern of vision-ocr/src/lib.rs:57-71): results must not leak between
    images."""
    from tests.test_smhocr import render_text_frame
    from smh_tpu.vision.reference import ReferenceBackend

    be = ReferenceBackend()
    be.load_frame(render_text_frame("900m"))
    be.crop_to_map(True)
    img = be.ocr_preprocess()
    first = engine.read(img)
    assert "900m" in [r.text for r in first]
    blank = np.full((64, 256), 255, np.uint8)
    assert engine.read(blank) == []
