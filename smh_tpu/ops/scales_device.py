"""Device-side scale reading: glyph OCR + bar scan as part of the fused pass.

The reference reads map scales on the host: Tesseract over the OCR image,
then a pixel walk for the |----| bar (src/vision/mod.rs:160-193,
src/vision/mpx_ratio.rs:3-134). Round 1/2 of this port moved the *transport*
of those images to adaptive bands; this module removes the transport
entirely: the device segments the text mask into glyphs, classifies each
glyph against digit/'m' templates with ONE small matmul, groups glyphs into
words, and speculatively runs the scale-bar scan for every word — all inside
the fused dispatch. The hostpack then carries ~1.2 KB of fixed-shape records
instead of image rows, and the host does no OCR at all.

Everything is static-shape: runs are extracted with sort-free compaction
into fixed slots (MAX_BANDS text-row bands x MAX_GPB glyph column-runs),
glyph windows are dynamic-slices of a padded plane, and the canonical 12x16
resample is a bilinear map_coordinates gather whose numpy twin
(ocr/glyphs.resample) generates the templates — glyphs and templates see the
*same* resampling operator, so the correlation scores are comparable (the
host engine smhocr.py uses the numpy twin for both sides the same way).

Capacity overflows (more bands/glyphs/words than slots, text taller than the
glyph window) set flags in the record header; the host falls back to the
image transport for that frame. The record semantics are validated against
the host engine on the reference screenshot corpus (tests/test_scales_device.py).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from .. import consts as C
from ..ocr import glyphs
from ..ocr.engine import OCR_BINARY_THRESHOLD

I16 = jnp.int16
I32 = jnp.int32
F32 = jnp.float32

# Canonical glyph box (shared with ocr/smhocr.py through ocr/glyphs.py, so
# the two engines share template geometry and confidence scales).
GLYPH_W, GLYPH_H = glyphs.GLYPH_W, glyphs.GLYPH_H
CHARS = glyphs.CHARS

# Static record capacities. A real scales overlay is <=3 short "<N>m" words;
# the slack absorbs stray whiteish UI text without tripping the fallback.
MAX_BANDS = 6  # text-row bands in the BRQ
MAX_GPB = 16  # glyph column-runs per band
MAX_WPB = 4  # words per band
MAX_WG = 6  # glyphs per word ("10000m" = 6)
WIN_H = 64  # band slice height (>= MAX_GLYPH_H + slack)
WIN_W = 48  # glyph window width cap

MIN_GLYPH_PX = 8
MIN_GLYPH_H = 5
MAX_GLYPH_H = 48
MIN_CONFIDENCE = 0.55

MIN_SCALE_WIDTH = 10
BAR_H = 4  # MIN_SCALE_VERTICAL_BAR_HEIGHT

# Record layout (i16 lanes).
# Header: [n_bands, global_flags, n_templates, band_flags_bitmask, 0 x4].
#   global_flags: FLAG_BAND_OVERFLOW = more text-row bands than slots (bands
#   beyond MAX_BANDS were never examined — the only loss the per-band bits
#   can't localize).
#   band_flags_bitmask: bit b set = band b compromised (more glyph runs than
#   slots, taller than the glyph window, or more words than slots) — every
#   word of that band is untrusted, other bands stay readable.
# Per word slot: n_glyphs, x0, y0, x1, y1, bar_found, bar_y, bar_left,
# bar_right, truncated, chars[6], scores[6] -> 22 i16, padded to 24.
HDR_I16 = 8
FLAG_BAND_OVERFLOW = 1
WORD_I16 = 24
N_WORDS = MAX_BANDS * MAX_WPB
REC_I16 = HDR_I16 + N_WORDS * WORD_I16
REC_BYTES = REC_I16 * 2


@functools.lru_cache(maxsize=1)
def device_templates() -> np.ndarray:
    """[T, GLYPH_H*GLYPH_W] f32 normalized templates (DejaVu digits + 'm',
    regular + bold, from ocr/glyphs.npz), resampled by the numpy twin of
    the device operator (ocr/glyphs.resample). Row t classifies as
    CHARS[t % len(CHARS)]."""
    return np.stack([t.reshape(-1) for _, t in glyphs.templates()])


def scan_budget(brq_w: int) -> int:
    """Rows below a text bottom the bar scan examines: the reference's
    round-half-up((20/640) * image_width) (src/vision/mpx_ratio.rs:24)."""
    return int((20.0 / 640.0) * brq_w + 0.5)


def _runs(mask: jnp.ndarray, max_runs: int):
    """First `max_runs` True-runs of a 1D bool mask: (starts, ends_exclusive,
    count). Padded slots have start == n.

    Sort-free compaction: rank each run boundary by a prefix sum, then gather
    boundary positions into their slots with a one-hot masked sum over
    [max_runs, n] — O(n * max_runs) trivially-fused work, no sort."""
    n = mask.shape[0]
    prev = jnp.concatenate([jnp.zeros((1,), bool), mask[:-1]])
    nxt = jnp.concatenate([mask[1:], jnp.zeros((1,), bool)])
    is_start = mask & ~prev
    is_end = mask & ~nxt
    iota = jnp.arange(n, dtype=I32)
    # rank[i] = index of the run that boundary i belongs to (0-based);
    # exclusive cumsum so the k-th start lands in slot k.
    rank = jnp.cumsum(is_start.astype(I32)) - 1
    slots = jnp.arange(max_runs, dtype=I32)
    start_hot = is_start[None, :] & (rank[None, :] == slots[:, None])
    end_hot = is_end[None, :] & (rank[None, :] == slots[:, None])
    # Exactly one hot per occupied slot; empty slots sum to 0 -> map to n.
    starts = (start_hot * iota[None, :]).sum(axis=1, dtype=I32)
    ends = (end_hot * iota[None, :]).sum(axis=1, dtype=I32)
    count = is_start.sum(dtype=I32)
    occupied = slots < count
    starts = jnp.where(occupied, starts, n)
    ends = jnp.where(occupied, ends, n) + 1
    return starts, ends, count


def _first_true(v: jnp.ndarray) -> jnp.ndarray:
    """Count of leading Falses (== index of first True; len(v) if none)."""
    out = ~v
    k = v.shape[0]
    s = 1
    while s < k:
        out = out & jnp.pad(out, (s, 0), constant_values=True)[:k]
        s *= 2
    return jnp.sum(out, dtype=I32)


def _glyph_features(text_pad, by0s, bhs, gx0s, gws, valids):
    """vmapped glyph feature extraction.

    text_pad: bool [H+WIN_H, W+WIN_W] padded text mask.
    by0s/bhs: [G] band row origin / band height per glyph slot.
    gx0s/gws: [G] column-run origin / width.
    Returns (feat [G, GLYPH_H*GLYPH_W], gy0 [G], gy1 [G], count [G], ok [G]).
    """

    def one(by0, bh, gx0, gw, valid):
        win = jax.lax.dynamic_slice(text_pad, (by0, gx0), (WIN_H, WIN_W))
        rmask = jnp.arange(WIN_H, dtype=I32) < bh
        cmask = jnp.arange(WIN_W, dtype=I32) < gw
        win = win & rmask[:, None] & cmask[None, :]
        rowany = win.any(axis=1)
        gy0 = _first_true(rowany)
        gy1 = WIN_H - _first_true(rowany[::-1])
        h = gy1 - gy0
        count = win.sum(dtype=I32)
        ok = (
            valid
            & (count >= MIN_GLYPH_PX)
            & (h >= MIN_GLYPH_H)
            & (h <= MAX_GLYPH_H)
            & (gw <= MAX_GLYPH_H)
        )
        # Canonical resample (device half of the ocr/glyphs.resample twin).
        fh = h.astype(F32)
        fw = gw.astype(F32)
        vi = gy0.astype(F32) + (jnp.arange(GLYPH_H, dtype=F32) + 0.5) * (
            fh / GLYPH_H
        ) - 0.5
        uj = (jnp.arange(GLYPH_W, dtype=F32) + 0.5) * (fw / GLYPH_W) - 0.5
        vv = jnp.broadcast_to(vi[:, None], (GLYPH_H, GLYPH_W))
        uu = jnp.broadcast_to(uj[None, :], (GLYPH_H, GLYPH_W))
        canon = jax.scipy.ndimage.map_coordinates(
            win.astype(F32), [vv, uu], order=1, mode="nearest"
        )
        feat = canon - canon.mean()
        norm = jnp.sqrt((feat * feat).sum())
        feat = jnp.where(norm > 1e-6, feat / norm, jnp.zeros_like(feat))
        return feat.reshape(-1), gy0, gy1, count, ok

    return jax.vmap(one)(by0s, bhs, gx0s, gws, valids)


def _classify(feats, templates):
    """One matmul against the templates -> (char_idx [G], score [G])."""
    # [G, T] correlations in full f32: they feed an argmax and the
    # MIN_CONFIDENCE gate, which a TF32 product could flip.
    scores = jnp.matmul(feats, templates.T, precision=jax.lax.Precision.HIGHEST)
    return jnp.argmax(scores, axis=1).astype(I32), jnp.max(scores, axis=1)


def _glyph_slots(text: jnp.ndarray):
    """Text-row bands and their glyph column-runs in fixed slots ->
    (text_pad, flags, n_bands, band_bad [MAX_BANDS], by0s, bhs, gx0s, gws,
    valids, bands), the per-glyph arrays [MAX_BANDS * MAX_GPB]."""
    h, w = text.shape
    text_pad = jnp.pad(text, ((0, WIN_H), (0, WIN_W)), constant_values=False)

    rowany = text.any(axis=1)
    b_starts, b_ends, n_bands = _runs(rowany, MAX_BANDS)
    flags = jnp.where(n_bands > MAX_BANDS, I32(FLAG_BAND_OVERFLOW), I32(0))

    # Per-band glyph column runs, vmapped over bands (an unrolled Python
    # loop here put tens of thousands of ops in the graph; the vmapped form
    # compiles the band body once).
    def band_info(b):
        by0 = jnp.minimum(b_starts[b], h)  # padded slot -> degenerate band
        by1 = jnp.minimum(b_ends[b], h)
        bh = jnp.maximum(by1 - by0, 0)
        band_valid = b < n_bands
        band = jax.lax.dynamic_slice(text_pad, (by0, 0), (WIN_H, w))
        band = band & (jnp.arange(WIN_H, dtype=I32) < bh)[:, None]
        colany = band.any(axis=0)
        g_starts, g_ends, n_g = _runs(colany, MAX_GPB)
        bad = band_valid & ((bh > WIN_H) | (n_g > MAX_GPB))
        gx0_b = jnp.minimum(g_starts, w)
        gw_b = jnp.maximum(jnp.minimum(g_ends, w) - gx0_b, 0)
        valid_b = band_valid & (jnp.arange(MAX_GPB, dtype=I32) < n_g)
        return by0, jnp.minimum(bh, WIN_H), bad, gx0_b, gw_b, valid_b

    by0_b, bh_b, band_bad, gx0_bg, gw_bg, valid_bg = jax.vmap(band_info)(
        jnp.arange(MAX_BANDS, dtype=I32)
    )
    by0s = jnp.repeat(by0_b, MAX_GPB)
    bhs = jnp.repeat(bh_b, MAX_GPB)
    gx0s = gx0_bg.reshape(-1)
    gws = gw_bg.reshape(-1)
    valids = valid_bg.reshape(-1)
    bands = jnp.repeat(jnp.arange(MAX_BANDS, dtype=I32), MAX_GPB)
    return text_pad, flags, n_bands, band_bad, by0s, bhs, gx0s, gws, valids, bands


def glyph_reads(text: jnp.ndarray, templates: jnp.ndarray):
    """Per glyph slot: (feat [G, 192], ok [G], char_idx [G], score [G]) —
    the classification scales_records packs into its words, exposed so a
    float64 evaluation of the same features can check the device matmul."""
    slots = _glyph_slots(text)
    feats, _gy0s, _gy1s, _counts, oks = _glyph_features(slots[0], *slots[4:9])
    chars, scores = _classify(feats, templates)
    return feats, oks, chars, scores


def scales_records(
    text: jnp.ndarray, sbool: jnp.ndarray, templates: jnp.ndarray
) -> jnp.ndarray:
    """The full device scales read -> i16 [REC_I16] record vector.

    text:  bool [H, W] OCR text mask (ocr_img < OCR_BINARY_THRESHOLD).
    sbool: bool [H, W] scales binarize plane (True = non-black; the bar scan
           reads black pixels, i.e. ~sbool).
    templates: f32 [T, 192] from device_templates().
    """
    h, w = text.shape
    (text_pad, flags, n_bands, band_bad, by0s, bhs, gx0s, gws, valids,
     bands) = _glyph_slots(text)
    feats, gy0s, gy1s, _counts, oks = _glyph_features(
        text_pad, by0s, bhs, gx0s, gws, valids
    )
    chars, scores = _classify(feats, templates)
    ay0 = by0s + gy0s  # absolute glyph bbox
    ay1 = by0s + gy1s
    ax0 = gx0s
    ax1 = gx0s + gws
    heights = ay1 - ay0

    # Word grouping per band: x-ordered surviving glyphs chain into the same
    # word while the horizontal gap stays within max(4, 0.9*min_h) and the
    # vertical overlap exceeds half the smaller height (ocr/smhocr.py:127-139).
    # Sequential in the glyph slot -> lax.scan (traced once), vmapped bands.
    def group_band(xs):
        def step(carry, x):
            wid, has_prev, px1, py0, py1, ph = carry
            alive, x0, x1, y0, y1, hh = x
            gap = x0 - px1
            v_overlap = jnp.minimum(y1, py1) - jnp.maximum(y0, py0)
            min_h = jnp.minimum(hh, ph)
            gap_max = jnp.maximum(I32(4), (9 * min_h) // 10)
            same = (
                has_prev & (v_overlap > min_h // 2) & (gap >= -2) & (gap <= gap_max)
            )
            new_wid = jnp.where(same, wid, wid + 1)
            carry = (
                jnp.where(alive, new_wid, wid),
                has_prev | alive,
                jnp.where(alive, x1, px1),
                jnp.where(alive, y0, py0),
                jnp.where(alive, y1, py1),
                jnp.where(alive, hh, ph),
            )
            return carry, jnp.where(alive, new_wid, I32(-1))

        init = (I32(-1), jnp.array(False), I32(0), I32(0), I32(0), I32(0))
        (widf, *_), word_of_b = jax.lax.scan(step, init, xs)
        return word_of_b, widf + 1

    xs_all = (
        oks.reshape(MAX_BANDS, MAX_GPB),
        ax0.reshape(MAX_BANDS, MAX_GPB),
        ax1.reshape(MAX_BANDS, MAX_GPB),
        ay0.reshape(MAX_BANDS, MAX_GPB),
        ay1.reshape(MAX_BANDS, MAX_GPB),
        heights.reshape(MAX_BANDS, MAX_GPB),
    )
    word_of_bg, words_in_band = jax.vmap(group_band)(xs_all)
    word_of = word_of_bg.reshape(-1)
    band_bad = band_bad | (words_in_band > MAX_WPB)

    # Scatter glyphs into word slots (invalid -> index MAX_WPB, dropped).
    slot_b = bands * MAX_WPB + jnp.clip(word_of, 0, MAX_WPB - 1)
    slot = jnp.where(
        (word_of >= 0) & (word_of < MAX_WPB), slot_b, N_WORDS
    )
    ginband = jnp.arange(MAX_BANDS * MAX_GPB, dtype=I32) % MAX_GPB
    # position of glyph within its word = rank among same-slot glyphs before it
    same_slot = (slot[None, :] == slot[:, None]) & (
        ginband[None, :] < ginband[:, None]
    )
    pos = same_slot.sum(axis=1).astype(I32)
    over = pos >= MAX_WG
    # A word that hit the glyph cap lost a SUFFIX of its glyphs; a suffix-
    # truncated read could still parse ("300mX" -> "300m"), so the word
    # carries a truncated flag and the host never trusts it.
    trunc_idx = jnp.where((slot < N_WORDS) & over, slot, N_WORDS)
    w_trunc = (
        jnp.zeros((N_WORDS + 1,), I32).at[trunc_idx].add(1, mode="drop")[:N_WORDS]
        > 0
    ).astype(I32)
    drop = jnp.where((slot < N_WORDS) & ~over, slot, N_WORDS)

    def scat(vals, fill):
        buf = jnp.full((N_WORDS + 1, MAX_WG), fill, vals.dtype)
        return buf.at[drop, jnp.minimum(pos, MAX_WG - 1)].set(
            vals, mode="drop"
        )[:N_WORDS]

    w_chars = scat(chars, I32(-1))
    w_scores = scat((scores * 1000.0).astype(I32), I32(0))
    w_n = scat(jnp.ones_like(slot), I32(0)).sum(axis=1)
    big = I32(1 << 14)
    w_x0 = scat(ax0, big).min(axis=1)
    w_y0 = scat(ay0, big).min(axis=1)
    w_x1 = scat(ax1, I32(0)).max(axis=1)
    w_y1 = scat(ay1, I32(0)).max(axis=1)

    # Speculative bar scan for every word slot (src/vision/mpx_ratio.rs
    # semantics incl. the right-1/left+1 steps and the ==0 sentinel quirks).
    budget = scan_budget(w)
    bar_black = ~sbool
    for k in range(1, BAR_H):
        shifted = jnp.pad(~sbool, ((0, k), (0, 0)))[k : k + h]
        bar_black = bar_black & shifted
    row_lim = h - BAR_H  # rows past h-4 can't host a full vertical bar
    riota = jnp.arange(h, dtype=I32)
    bar_black = bar_black & (riota <= row_lim)[:, None]
    ciota = jnp.arange(w, dtype=I32)

    def scan_word(x0, x1, y_bot, n_glyphs):
        x = (x0 + x1) // 2
        ys = y_bot + jnp.arange(budget, dtype=I32)
        ys_c = jnp.clip(ys, 0, h - 1)
        bb = bar_black[ys_c]  # [budget, w]
        anchor_black = ~sbool[ys_c, x]
        right_cand = jnp.where(bb & (ciota[None, :] >= x), ciota[None, :], w)
        rx = right_cand.min(axis=1)
        left_cand = jnp.where(bb & (ciota[None, :] < x), ciota[None, :], -1)
        lx = left_cand.max(axis=1)
        right = rx - 1
        left = lx + 1
        width = right - left
        okrow = (
            (ys < h)
            & anchor_black
            & (rx < w)
            & (rx != 0)  # reference sentinel: a bar at column 0 reads as miss
            & (lx >= 0)
            & (lx != 0)  # same sentinel on the left walk
            & (width >= MIN_SCALE_WIDTH)
        )
        k = _first_true(okrow)
        found = (k < budget) & (n_glyphs > 0) & (y_bot >= BAR_H)
        k_c = jnp.minimum(k, budget - 1)
        return (
            found,
            jnp.where(found, ys[k_c], 0),
            jnp.where(found, left[k_c], 0),
            jnp.where(found, right[k_c], 0),
        )

    bar_found, bar_y, bar_l, bar_r = jax.vmap(scan_word)(w_x0, w_x1, w_y1, w_n)

    band_bits = (band_bad.astype(I32) * (1 << jnp.arange(MAX_BANDS))).sum()
    hdr = jnp.zeros((HDR_I16,), I32)
    hdr = hdr.at[0].set(jnp.minimum(n_bands, MAX_BANDS))
    hdr = hdr.at[1].set(flags)
    hdr = hdr.at[2].set(templates.shape[0])
    hdr = hdr.at[3].set(band_bits)
    word_rec = jnp.concatenate(
        [
            w_n[:, None],
            jnp.where(w_n > 0, w_x0, 0)[:, None],
            jnp.where(w_n > 0, w_y0, 0)[:, None],
            w_x1[:, None],
            w_y1[:, None],
            bar_found.astype(I32)[:, None],
            bar_y[:, None],
            bar_l[:, None],
            bar_r[:, None],
            w_trunc[:, None],
            w_chars,
            jnp.clip(w_scores, -(1 << 14), 1 << 14),
            jnp.zeros((N_WORDS, WORD_I16 - 10 - 2 * MAX_WG), I32),
        ],
        axis=1,
    )
    rec = jnp.concatenate([hdr, word_rec.reshape(-1)])
    return rec.astype(I16)


# ---------------------------------------------------------------------------
# Host-side decode
# ---------------------------------------------------------------------------


class DeviceScales:
    """Decoded record buffer: OcrResult-compatible words + per-word bar scans.

    `complete` means the device saw the whole plane with no capacity loss;
    when False, `trusted[i]` still marks the words whose band was clean and
    whose glyphs were not truncated — those reads are exact. The production
    policy (tpu_backend.device_scales): use the trusted reads when they
    produce a ratio; fall back to the image transport only when structure
    was lost AND the trusted reads found nothing."""

    __slots__ = (
        "complete", "words", "bars", "trusted", "n_bands", "flags",
        "band_bits", "_ratio_memo",
    )

    def __init__(self, complete, words, bars, trusted, n_bands, flags, band_bits):
        self.complete = complete
        self.words = words  # list[OcrResult]
        self.bars = bars  # per word: None | (y, left, right)
        self.trusted = trusted  # per word: band clean & not truncated
        self.n_bands = n_bands
        self.flags = flags
        self.band_bits = band_bits
        self._ratio_memo = ()  # unset sentinel (None is a valid ratio)

    @property
    def ok(self) -> bool:
        return self.complete


def decode_records(rec_i16: np.ndarray) -> DeviceScales:
    """Parse the i16 record vector (already byte-order native)."""
    from ..ocr.engine import OcrResult

    hdr = rec_i16[:HDR_I16]
    n_bands = int(hdr[0])
    flags = int(hdr[1])
    band_bits = int(hdr[3])
    complete = flags == 0 and band_bits == 0
    words: list = []
    bars: list = []
    trusted: list = []
    recs = rec_i16[HDR_I16:].reshape(N_WORDS, WORD_I16)
    for slot_idx, r in enumerate(recs):
        n = int(r[0])
        if n <= 0:
            continue
        chars = r[10 : 10 + MAX_WG]
        scores = r[10 + MAX_WG : 10 + 2 * MAX_WG].astype(np.float32) / 1000.0
        text = ""
        ss = []
        for i in range(min(n, MAX_WG)):
            idx = int(chars[i])
            sc = float(scores[i])
            ch = CHARS[idx % len(CHARS)] if idx >= 0 else "?"
            text += ch if sc >= MIN_CONFIDENCE else "?"
            ss.append(max(sc, 0.0))
        words.append(
            OcrResult(
                text=text,
                confidence=float(np.mean(ss)) * 100.0 if ss else 0.0,
                left=int(r[1]),
                top=int(r[2]),
                right=int(r[3]),
                bottom=int(r[4]),
            )
        )
        bars.append((int(r[6]), int(r[7]), int(r[8])) if int(r[5]) else None)
        band = slot_idx // MAX_WPB
        trusted.append(not (band_bits >> band) & 1 and not int(r[9]))
    return DeviceScales(complete, words, bars, trusted, n_bands, flags, band_bits)


def ratio_from_records(dev: DeviceScales) -> "float | None":
    """meters/px from the TRUSTED decoded records, mirroring _parse_scales +
    calc_meters_to_px_ratio (<=3 scales, dedup by value, average).

    Selection order: the first <=3 trusted scales in band-major record-slot
    order (top band first, left-to-right within a band). The host engine
    path instead takes OCR-result emission order over all words; with more
    than 3 distinct "<N>m" labels on screen (never the case for the real
    overlay, which shows <=3) or a partially-trusted frame the averaged
    subset can differ from the host fallback's. Corpus-validated equivalent
    for real frames. Memoized per record object (decoding is per-frame;
    multiple consumers — serve gate, job payload, sync path — share one
    computation)."""
    if dev._ratio_memo != ():
        return dev._ratio_memo[0]
    scales = []
    seen = set()
    for word, bar, trust in zip(dev.words, dev.bars, dev.trusted):
        if not trust:
            continue
        m = word.text.rfind("m")
        if m < 0:
            continue
        prefix = word.text[:m]
        if not prefix.isdigit():
            continue
        meters = int(prefix)
        if meters == 0 or meters in seen:
            continue
        seen.add(meters)
        scales.append((meters, bar))
        if len(scales) == 3:
            break
    found = []
    for meters, bar in scales:
        if bar is None:
            continue
        _y, left, right = bar
        width = right - left
        if width >= MIN_SCALE_WIDTH:
            found.append(meters / width)
    ratio = sum(found) / len(found) if found else None
    dev._ratio_memo = (ratio,)
    return ratio
