"""The REAL Tesseract, when the environment provides it.

The reference embeds eng.traineddata and runs genuine LSTM Tesseract on
every frame (/root/reference/vision-ocr/src/lib.rs:129-159, ocr.cpp:7-55). This
image carries the real libtesseract.so.5 but no traineddata (zero egress),
so these tests validate what CAN be validated here — the ctypes binding
against the genuine library ABI — and gate the full model path on
`eng.traineddata` being present (it runs for free on any host with
`tesseract-ocr-eng` installed; skips cleanly otherwise)."""

import ctypes
import os

import numpy as np
import pytest

from smh_tpu.ocr import tesseract as T


def _real_lib() -> "ctypes.CDLL | None":
    """The system Tesseract, explicitly NOT the in-repo smhtess shim."""
    for name in ("libtesseract.so.5", "libtesseract.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


@pytest.mark.skipif(_real_lib() is None, reason="no system libtesseract")
def test_binding_symbols_match_real_abi():
    """Every symbol the engine binds must exist in the genuine library with
    a callable lifecycle: Create -> Version -> Delete. This catches binding
    drift (renamed/miss-spelled C API symbols) without needing a model."""
    lib = _real_lib()
    for sym in (
        "TessBaseAPICreate", "TessBaseAPIDelete", "TessBaseAPIInit2",
        "TessBaseAPISetImage", "TessBaseAPIGetIterator",
        "TessResultIteratorGetUTF8Text", "TessResultIteratorConfidence",
        "TessResultIteratorGetPageIterator", "TessPageIteratorBoundingBox",
        "TessResultIteratorNext", "TessResultIteratorDelete",
        "TessDeleteText", "TessBaseAPISetSourceResolution",
        "TessBaseAPISetPageSegMode", "TessBaseAPIRecognize", "TessVersion",
    ):
        assert hasattr(lib, sym), f"real ABI lacks {sym}"
    lib.TessVersion.restype = ctypes.c_char_p
    version = lib.TessVersion().decode()
    assert version and version[0].isdigit(), version
    lib.TessBaseAPICreate.restype = ctypes.c_void_p
    lib.TessBaseAPIDelete.argtypes = [ctypes.c_void_p]
    api = lib.TessBaseAPICreate()
    assert api
    lib.TessBaseAPIDelete(api)


def _real_available() -> bool:
    if _real_lib() is None:
        return False
    return T.find_tessdata("eng") is not None


@pytest.mark.skipif(
    not _real_available(),
    reason="real libtesseract + eng.traineddata not both present",
)
def test_real_lstm_reads_rendered_scale_text(monkeypatch):
    """Full engine path against the real LSTM model: render the same bright
    monochrome glyphs the game draws, expect a '300m' TEXTLINE with a sane
    bbox. Runs automatically on any host with tesseract-ocr-eng installed."""
    monkeypatch.delenv("SMH_TESS_LIB", raising=False)

    # A BRQ-sized canvas with "300m" rendered at OCR-preprocess polarity
    # (dark text on light background reads best; the engine consumes the
    # already-thresholded gray image the device ships).
    img = np.full((200, 400), 255, dtype=np.uint8)
    glyphs = _render_text_mask("300m", height=24)
    gh, gw = glyphs.shape
    img[60 : 60 + gh, 40 : 40 + gw][glyphs > 0] = 0

    engine = T.TesseractEngine()
    results = engine.read(img, dpi=96)
    texts = [r.text.replace(" ", "") for r in results]
    assert any("300m" in t for t in texts), results
    hit = next(r for r in results if "300m" in r.text.replace(" ", ""))
    assert 0 <= hit.left < hit.right <= 400 and 0 <= hit.top < hit.bottom <= 200


def _render_text_mask(text: str, height: int) -> np.ndarray:
    """Tightly-cropped u8 0/255 glyph mask of `text` in DejaVu Sans."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf", height)
    img = Image.new("L", (height * len(text) + 8, height + 12), 0)
    ImageDraw.Draw(img).text((2, 2), text, fill=255, font=font)
    mask = (np.asarray(img) > 128).astype(np.uint8) * np.uint8(255)
    ys, xs = np.nonzero(mask)
    return mask[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
