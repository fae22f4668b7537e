"""Committed glyph data: the scale readers' templates and the label masks
synthetic frames draw.

glyphs.npz is rendered once from DejaVu Sans by tools/gen_glyphs.py, so the
program reads glyphs without PIL or system fonts. The canonical resample
lives here too: the host reader (ocr/smhocr.py), the device reader
(ops/scales_device.py, whose jnp twin must match it) and the smhtess C
model (native/smhtess.cpp normalize_glyph) all map a glyph onto the same
GLYPH_H x GLYPH_W grid, so their correlation scores are comparable.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

GLYPHS_NPZ = pathlib.Path(__file__).resolve().parent / "glyphs.npz"

GLYPH_W, GLYPH_H = 12, 16
CHARS = "0123456789m"
TEMPLATE_STYLES = ("regular", "bold")
# Scale labels synthetic frames can draw (testing.make_frame scale_texts).
SCALE_TEXTS = (
    "50m", "75m", "100m", "150m", "200m", "300m", "600m", "900m", "1200m",
)


@functools.lru_cache(maxsize=1)
def _data() -> dict[str, np.ndarray]:
    with np.load(GLYPHS_NPZ) as npz:
        return {k: npz[k] for k in npz.files}


def resample(window: np.ndarray) -> np.ndarray:
    """Bilinear sample of `window` (float [h, w]) onto the canonical
    GLYPH_H x GLYPH_W grid: destination pixel centre i+0.5 maps to source
    (i+0.5)*scale-0.5, edges clamped."""
    from scipy import ndimage as ndi

    h, w = window.shape
    vi = (np.arange(GLYPH_H, dtype=np.float64) + 0.5) * (h / GLYPH_H) - 0.5
    uj = (np.arange(GLYPH_W, dtype=np.float64) + 0.5) * (w / GLYPH_W) - 0.5
    vv, uu = np.meshgrid(vi, uj, indexing="ij")
    return ndi.map_coordinates(
        window.astype(np.float64), [vv, uu], order=1, mode="nearest"
    ).astype(np.float32)


def normalize(glyph: np.ndarray) -> np.ndarray:
    """Canonical resample, then zero-mean / unit-norm (so correlation is
    brightness invariant) -> float32 [GLYPH_H, GLYPH_W]."""
    arr = resample(glyph)
    arr = arr - arr.mean()
    n = np.linalg.norm(arr)
    return arr / n if n > 1e-6 else arr


@functools.lru_cache(maxsize=1)
def templates() -> tuple[tuple[str, np.ndarray], ...]:
    """(char, normalized [GLYPH_H, GLYPH_W] template) for every character of
    CHARS in each of TEMPLATE_STYLES, in that order: entry t classifies as
    CHARS[t % len(CHARS)]."""
    out = []
    data = _data()
    for style in TEMPLATE_STYLES:
        for ch, arr in zip(CHARS, data[f"tpl_{style}"]):
            ys, xs = np.nonzero(arr > 64)
            crop = arr[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
            out.append((ch, normalize(crop.astype(np.float32) / 255.0)))
    return tuple(out)


def text_mask(text: str) -> np.ndarray:
    """bool [30, 20*len(text)+8] mask of a scale label at 20 px, drawn at
    (2, 2) of its canvas."""
    try:
        return _data()[f"text_{text}"]
    except KeyError:
        raise KeyError(
            f"no glyph mask for {text!r}: add it to SCALE_TEXTS and run "
            "tools/gen_glyphs.py"
        ) from None
