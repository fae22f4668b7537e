"""Render the committed glyph data, smh_tpu/ocr/glyphs.npz.

The scale readers (ocr/smhocr.py, ops/scales_device.py, the smhtess model
written by ocr/tessdata_gen.py) classify glyphs against DejaVu Sans digit
and 'm' templates, and the synthetic frames of smh_tpu/testing.py draw
scale labels in the same font. The program reads both from the .npz, so it
needs neither PIL nor the fonts at run time. This script is the one place
that renders them; tests/test_glyphs.py checks the committed file against a
fresh render wherever PIL and DejaVu exist.

Usage:
  python tools/gen_glyphs.py
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from smh_tpu.ocr import glyphs  # noqa: E402

FONT_DIR = pathlib.Path("/usr/share/fonts/truetype/dejavu")
FONTS = {"regular": "DejaVuSans.ttf", "bold": "DejaVuSans-Bold.ttf"}


def render() -> dict[str, np.ndarray]:
    """Every array of glyphs.npz, freshly rendered with PIL."""
    from PIL import Image, ImageDraw, ImageFont

    out: dict[str, np.ndarray] = {}
    # Templates: each character at 32 px on a 64x64 canvas, drawn at (8, 8).
    for style in glyphs.TEMPLATE_STYLES:
        font = ImageFont.truetype(str(FONT_DIR / FONTS[style]), 32)
        renders = []
        for ch in glyphs.CHARS:
            img = Image.new("L", (64, 64), 0)
            ImageDraw.Draw(img).text((8, 8), ch, fill=255, font=font)
            renders.append(np.asarray(img))
        out[f"tpl_{style}"] = np.stack(renders)
    # Scale labels as synthetic frames draw them: 20 px regular on a
    # (30, 20*len+8) canvas at (2, 2), thresholded at > 128. 20 px reads at
    # ~95% confidence with smhocr; below ~18 px the thresholded glyph shapes
    # drift too far from the templates.
    font = ImageFont.truetype(str(FONT_DIR / FONTS["regular"]), 20)
    for text in glyphs.SCALE_TEXTS:
        img = Image.new("L", (20 * len(text) + 8, 30), 0)
        ImageDraw.Draw(img).text((2, 2), text, fill=255, font=font)
        out[f"text_{text}"] = np.asarray(img) > 128
    return out


def main() -> int:
    data = render()
    np.savez_compressed(glyphs.GLYPHS_NPZ, **data)
    print(f"wrote {glyphs.GLYPHS_NPZ} ({glyphs.GLYPHS_NPZ.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
