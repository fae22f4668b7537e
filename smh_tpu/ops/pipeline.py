"""The fused per-frame device pass.

Replaces the reference's per-stage CUDA kernels + 4-stream juggling
(/root/reference/vision-gpu/src/lib.rs:207-479, cuda/cuda.cu:312-635) with:

  * `red_gate(frame)`    — tiny dispatch over the close-button ROI, scalar out
                           (mirrors count_close_deployment_button_red_pixels,
                           cuda.cu:312-352, but as a deterministic mean).
  * `analyze_frame(...)` — ONE jitted function computing ui_map, the dilated
                           LSD mask, the OCR image and the scales binarize in
                           a single traced graph. XLA fuses the HSV/luma/
                           threshold work so the frame is swept once, instead
                           of the reference's 3-4 reads of the same pixels
                           across kernels (cuda.cu:354-406,519-546,616-635).

Everything is shape-specialized per frame resolution ("shape buckets"): the
reference reallocates per-resolution buffers on resize (vision-gpu:118-124);
here a resize simply compiles a new bucket, cached by (h, w, flags).

Hostpack v2 — the critical-path D2H payload. The per-frame fetch carries
only what the markers path needs:

  * the LSD mask travels SPARSE (default): the device compacts the
    nonzero u32 words of the bit-packed plane (searchsorted-gather) and the
    pack carries indices + words under a static
    budget — ~5 KB for a real 4K marker mask. Reconstruction is the full
    plane bit-for-bit, so detection is exactly the full-mask computation.
    nz > budget is a detected miss: the host falls back to fetching the full
    bit-mask (kept device-resident) and escalates the budget rung.
  * SMH_SPARSE=0 selects the *windowed crop*: the device computes the
    dilated marker mask's bounding box (masked cumulative-AND reductions,
    no argmax) and dynamic-slices
    a static-size window around it. The window carries LSD_CROP_MARGIN >=
    max_gap + centre-snap px of black context, so running the seed scan +
    ray march on the crop is *exactly* equivalent to running it on the full
    mask (rays die on max_gap+1 background samples before they can reach the
    window edge). If the bbox outgrows the window, the host detects it from
    the bbox in the pack and falls back the same way, then re-buckets.
  * the OCR image and scales binarize move OFF the critical path entirely:
    the pack carries only their checksums; the images live in a separate
    device-resident "scalespack" the scales branch fetches only when the
    checksums changed (the reference D2H-pins and transfers the OCR image
    every frame, vision-gpu/src/gpuimage.rs:117-167).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from .. import consts as C, jax_cache
from . import hsv

# Every compile in the framework flows through this module's jit buckets, so
# the persistent compilation cache is activated here — ad-hoc scripts that
# import nothing but the pipeline still get warm starts.
jax_cache.enable()

F32 = jnp.float32
I32 = jnp.int32

# Black context around the LSD bbox inside the crop window. Any value
# >= LSD_MAX_GAP + 2 (ray death) and >= LSD_CENTRE_MAX_DIST (seed snapping)
# makes crop-local detection bit-identical to full-mask detection.
LSD_CROP_MARGIN = C.LSD_MAX_GAP + C.LSD_CENTRE_MAX_DIST + 4  # 24


def _bgra_to_rgb(bgra: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([bgra[..., 2], bgra[..., 1], bgra[..., 0]], axis=-1)


def _dilate_l1_radius1_bool(m: jnp.ndarray) -> jnp.ndarray:
    """Cross-shaped (L1 r=1) binary dilation via shifted ORs."""
    out = m
    out = out | jnp.pad(m, ((1, 0), (0, 0)))[:-1, :]
    out = out | jnp.pad(m, ((0, 1), (0, 0)))[1:, :]
    out = out | jnp.pad(m, ((0, 0), (1, 0)))[:, :-1]
    out = out | jnp.pad(m, ((0, 0), (0, 1)))[:, 1:]
    return out


def _box_dilate_bool(m: jnp.ndarray, radius: int) -> jnp.ndarray:
    """(2r+1)^2 separable box dilation with edge clamping."""
    out = m
    for axis in (0, 1):
        acc = out
        for d in range(1, radius + 1):
            if axis == 0:
                acc = acc | jnp.pad(out, ((d, 0), (0, 0)))[:-d, :]
                acc = acc | jnp.pad(out, ((0, d), (0, 0)))[d:, :]
            else:
                acc = acc | jnp.pad(out, ((0, 0), (d, 0)))[:, :-d]
                acc = acc | jnp.pad(out, ((0, 0), (0, d)))[:, d:]
        out = acc
    return out


def pack_bits(mask_bool: jnp.ndarray) -> jnp.ndarray:
    """Pack a bool [h, w] mask into u8 [h, ceil(w/8)] (MSB-first, matching
    np.unpackbits). Binary masks travel as bits: 8x fewer D2H bytes."""
    h, w = mask_bool.shape
    w8 = ((w + 7) // 8) * 8
    padded = jnp.pad(mask_bool, ((0, 0), (0, w8 - w))).reshape(h, w8 // 8, 8)
    weights = jnp.array([128, 64, 32, 16, 8, 4, 2, 1], dtype=jnp.uint8)
    return (padded.astype(jnp.uint8) * weights[None, None, :]).sum(axis=2, dtype=jnp.int32).astype(jnp.uint8)


def unpack_bits_host(packed: "np.ndarray", w: int) -> "np.ndarray":
    """Host-side inverse of pack_bits -> 0/1 u8 [h, w]."""
    import numpy as np

    return np.unpackbits(packed, axis=1)[:, :w]


def bbox_crop_host(
    bits: "np.ndarray",
    bbox: tuple[int, int, int, int],
    origin: tuple[int, int],
    shape: tuple[int, int],
) -> tuple["np.ndarray", tuple[int, int]]:
    """Unpack ONLY the mask-bbox + LSD_CROP_MARGIN slice of a bit-packed LSD
    plane -> (0/255 u8 crop, (ox, oy) full-plane offset of the crop).

    Exact by the same argument that makes the window transport exact
    (module docstring above): the march semantics need at most
    LSD_CROP_MARGIN px of black context around any mask pixel, and the
    dilated mask is all-zero outside `bbox` — so rows/cols beyond
    bbox+margin can never change a seed, a centre snap, or a march. This
    cuts host unpack + native-scan work from the (fixed) window area to the
    actual content area.

    bits: (ch, (cw+7)//8) bit rows of a crop whose top-left is `origin`
    (ox, oy) in map space; bbox: absolute end-exclusive (y0, y1, x0, x1);
    shape: logical (ch, cw) of the crop. Caller handles the empty bbox.
    """
    import numpy as np

    y0, y1, x0, x1 = bbox
    ox, oy = origin
    ch, cw = shape
    m = int(LSD_CROP_MARGIN)  # 24.0: CENTRE_MAX_DIST is a float const
    r0 = max(0, y0 - oy - m)
    r1 = min(ch, y1 - oy + m)
    # Byte-aligned column slice: bits past x1+margin inside the last byte
    # are zero (no mask pixels there), so whole bytes are safe to keep —
    # but the unpacked width must still be trimmed to the logical plane
    # width (map widths are rarely byte-aligned; a crop overhanging the
    # plane breaks canvas-paste consumers).
    b0 = max(0, x0 - ox - m) // 8
    b1 = min((cw + 7) // 8, (x1 - ox + m + 7) // 8)
    sub = np.ascontiguousarray(bits[r0:r1, b0:b1])
    wlim = min(b1 * 8, cw) - b0 * 8
    crop = np.unpackbits(sub, axis=1)[:, :wlim] * np.uint8(255)
    return crop, (ox + b0 * 8, oy + r0)


def sparse_word_pad(bpr: int) -> int:
    """Bit-row bytes padded up to whole u32 words (the sparse transport's
    word grid; pad bytes are always zero so they never produce a word)."""
    return ((bpr + 3) // 4) * 4


def _pack_words32(mask_bool: jnp.ndarray) -> jnp.ndarray:
    """Pack a bool [h, w] mask into the flat u32 word plane the sparse
    transport ships: word j of row i covers pixels [32j, 32j+32), laid out
    so the HOST byte view of each little-endian u32 reproduces pack_bits'
    MSB-first bytes (pixel p -> byte lane p//8 % 4, bit 7 - p%8).

    Computed straight from the bools with one weighted sum — bitcasting
    pack_bits' u8 output to u32 instead crosses the (32,128)->(8,128) tile
    layouts (a shift+or-reduce lowering the cost model flags at 87% of the
    standalone compaction program's cycles)."""
    h, w = mask_bool.shape
    w32 = ((w + 31) // 32) * 32
    padded = jnp.pad(mask_bool, ((0, 0), (0, w32 - w))).reshape(h, w32 // 32, 32)
    p = jnp.arange(32)
    weights = (jnp.uint32(1) << (8 * (p // 8) + (7 - p % 8)).astype(jnp.uint32))
    return (
        (padded.astype(jnp.uint32) * weights[None, None, :])
        .sum(axis=2, dtype=jnp.uint32)
        .reshape(-1)
    )


def _compact_words(words: jnp.ndarray, budget: int, engine: str | None = None):
    """First `budget` nonzero words of a flat u32 plane: (nz i32 scalar =
    TOTAL nonzero count, idx i32 [budget], dat u32 [budget]); slots past
    min(nz, budget) are zero.

    engine "search" (default): binary search of each output rank over the
    monotonic inclusive prefix count (searchsorted + two gathers — NO
    scatter op). "scatter": prefix-sum scatter — kept as the cross-check
    twin; the search engine was the faster of the two inside the large
    fused program where first measured (re-measuring on the H100 is ROADMAP
    Queue 3 item 4). Both are exact and produce identical sections.
    SMH_COMPACT overrides the default — read at TRACE time, so set it
    before the first dispatch (same-shape retraces won't pick up a flip)."""
    if engine is None:
        engine = os.environ.get("SMH_COMPACT", "search")
    nzmask = words != jnp.uint32(0)
    count = jnp.cumsum(nzmask.astype(jnp.int32))  # inclusive: rank+1 at hits
    nz = count[-1]
    if engine == "search":
        # found[j] = first i with count[i] == j+1 = the j-th nonzero word.
        found = jnp.searchsorted(
            count, jnp.arange(1, budget + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        valid = jnp.arange(budget, dtype=jnp.int32) < jnp.minimum(nz, budget)
        src = jnp.where(valid, jnp.minimum(found, words.size - 1), 0)
        dat = jnp.where(valid, words[src], jnp.uint32(0))
        return nz, src, dat  # src doubles as idx (0 in invalid slots)
    pos = count - 1
    oidx = jnp.where(nzmask & (pos < budget), pos, budget)
    dat = (
        jnp.zeros((budget + 1,), jnp.uint32).at[oidx].set(words, mode="drop")[:budget]
    )
    idx = (
        jnp.zeros((budget + 1,), jnp.int32)
        .at[oidx]
        .set(jnp.arange(words.size, dtype=jnp.int32), mode="drop")[:budget]
    )
    return nz, idx, dat


def _sparse_words(mask_bool: jnp.ndarray, budget: int):
    """Compact the nonzero u32 words of a bool [h, w] mask plane (see
    _compact_words). Word indices are in the PADDED grid (sparse_word_pad
    columns of u8 per row) so the host reconstructs with one flat u32
    scatter + byte view."""
    return _compact_words(_pack_words32(mask_bool), budget)


def sparse_mask_host(
    nz: int, idx: "np.ndarray", dat: "np.ndarray", map_h: int, map_w: int
) -> "np.ndarray":
    """Host-side inverse of _sparse_words -> bit-packed u8 [map_h, bpr]
    plane (the same layout pack_bits emits). Exact only when nz fit the
    budget (idx.size); the caller falls back to the full lsd_bits fetch
    otherwise."""
    import numpy as np

    bpr = (map_w + 7) // 8
    bpr4 = sparse_word_pad(bpr)
    buf = np.zeros(map_h * (bpr4 // 4), dtype=np.uint32)
    k = min(int(nz), idx.size)
    buf[idx[:k]] = dat[:k]
    return buf.view(np.uint8).reshape(map_h, bpr4)[:, :bpr]


def binary_ocr_image_host(keep_bits: "np.ndarray", w: int) -> "np.ndarray":
    """Reconstruct the 0/255 OCR image from the bit-packed text mask — the
    host side of the binary transport (exact for binary_ok engines, which
    only evaluate `gray < OCR_BINARY_THRESHOLD`)."""
    import numpy as np

    keep = unpack_bits_host(keep_bits, w)
    return np.where(keep != 0, np.uint8(0), np.uint8(255))


@functools.partial(jax.jit, static_argnames=("w",))
def unpack_bits_device(packed: jnp.ndarray, w: int) -> jnp.ndarray:
    """Device-side inverse of pack_bits -> 0/255 u8 [h, w] (rebuilds the
    full LSD mask for the device ray-march engine when the fused pass was
    dispatched without the mask output)."""
    h, row = packed.shape
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint8(1)
    return (bits.reshape(h, row * 8)[:, :w] * jnp.uint8(255))


def _first_true_count(v: jnp.ndarray) -> jnp.ndarray:
    """Index of the first True in a 1D bool vector (len(v) if none), as the
    add-reduce of a log-shift cumulative AND of ~v (vectorized; no argmax
    or min-over-iota)."""
    out = ~v
    k = v.shape[0]
    s = 1
    while s < k:
        out = out & jnp.pad(out, (s, 0), constant_values=True)[:k]
        s *= 2
    return jnp.sum(out, dtype=I32)


def _mask_bbox(m: jnp.ndarray):
    """Bounding box (y0, y1, x0, x1) of True pixels, end-exclusive.
    Empty mask -> y0 == h, y1 == 0 (host detects y0 >= y1)."""
    rowany = m.any(axis=1)
    colany = m.any(axis=0)
    h = m.shape[0]
    w = m.shape[1]
    y0 = _first_true_count(rowany)
    y1 = jnp.int32(h) - _first_true_count(rowany[::-1])
    x0 = _first_true_count(colany)
    x1 = jnp.int32(w) - _first_true_count(colany[::-1])
    return y0, y1, x0, x1


def _weighted_check(plane: jnp.ndarray) -> jnp.ndarray:
    """[2] u32 content checksum (sum + position-weighted sum) of a 2D u8/u32
    plane. Cheap device-side change detection: both the ui-push skip and the
    scales-branch skip key on these (the reference uses a host crc32 for the
    same purpose, src/ui/map.rs:222-233)."""
    p = plane.astype(jnp.uint32)
    h, w = p.shape
    ww = (jax.lax.broadcasted_iota(jnp.uint32, (h, w), 0) + 1) * (
        jax.lax.broadcasted_iota(jnp.uint32, (h, w), 1) + 7
    )
    return jnp.stack([p.sum(dtype=jnp.uint32), (p * ww).sum(dtype=jnp.uint32)])


def _minimap_rect(quiet: jnp.ndarray) -> jnp.ndarray:
    """Minimap bounds from the low-edginess mask, entirely on device.

    Exact port of the reference walk (src/vision/find_minimap.rs:48-146, same
    semantics as vision/find_minimap.find_minimap_quiet): from the map centre
    march each of the 4 directions to the first quiet pixel that starts a
    straight quiet run >= half-span toward the centre's far side, and step
    one back. The run checks are static-slice AND-reductions (the run always
    starts at the centre row/col) and the walks are first-true searches via
    log-shift cumulative ANDs — no argmax, no host roundtrip. Ships as 16
    bytes in the hostpack instead of the packed quiet mask (h*w/8 bytes).

    Returns i32 [4] = (left, top, right, bottom).
    """
    h, w = quiet.shape
    cx, cy = w // 2, h // 2
    lv = abs(h - cy) // 2 - 1  # vertical run length (left/right candidates)
    lh = abs(w - cx) // 2 - 1  # horizontal run length (up/down candidates)
    # packed_counts packs two masked popcounts into one i32 at weights 1 and
    # 2^12; a run length >= 4096 (map ROI dimension >= ~16 K) would bleed
    # into the upper field and corrupt both run checks. Fail loudly instead.
    assert lv < 4096 and lh < 4096, (
        f"minimap run length {max(lv, lh)} overflows the packed dual popcount"
    )
    riota = jax.lax.iota(I32, h)
    ciota = jax.lax.iota(I32, w)

    # Each large reduction over the quiet plane may re-run the fused
    # (8-neighbour) edginess producer for its own pass instead of reading a
    # materialized plane. Both run-checks per axis therefore ride ONE
    # weighted sum: counts < 2^12 pixels, so two masked popcounts pack into
    # a single i32 lane at weights 1 and 2^12 — two reduction passes total.
    def packed_counts(iota, lo_a, hi_a, lo_b, hi_b, axis):
        in_a = ((iota >= lo_a) & (iota < hi_a)).astype(I32)
        in_b = ((iota >= lo_b) & (iota < hi_b)).astype(I32)
        wvec = in_a + (in_b << 12)
        wgt = wvec[:, None] if axis == 0 else wvec[None, :]
        s = (quiet.astype(I32) * wgt).sum(axis=axis)
        return s & 0xFFF, s >> 12

    def run_check(count, lo: int, hi: int, dim: int, out_dim: int):
        """Original walk-bound rule: empty run -> all pass; run outside
        [3, dim-3] -> none pass; else the masked popcount must equal the
        run length."""
        if hi <= lo:
            return jnp.ones((out_dim,), bool)
        if lo < 3 or (hi - 1) > dim - 3:
            return jnp.zeros((out_dim,), bool)
        return count == (hi - lo)

    # Column checks: run downward (cy+1..cy+lv) and upward (cy-lv..cy-1).
    ca, cb = packed_counts(riota, cy + 1, cy + 1 + lv, cy - lv, cy, axis=0)
    down_run = run_check(ca, cy + 1, cy + 1 + lv, h, w)
    up_run = run_check(cb, cy - lv, cy, h, w)
    ra, rb = packed_counts(ciota, cx + 1, cx + 1 + lh, cx - lh, cx, axis=1)
    right_run = run_check(ra, cx + 1, cx + 1 + lh, w, h)
    left_run = run_check(rb, cx - lh, cx, w, h)

    centre_row = quiet[cy, :]
    centre_col = quiet[:, cx]
    left_q = centre_row & down_run  # run downward
    right_q = centre_row & up_run  # run upward
    up_q = centre_col & right_run  # run rightward
    down_q = centre_col & left_run  # run leftward

    def walk_down(q: jnp.ndarray, start: int) -> jnp.ndarray:
        """First qualifying index walking start-1, start-2, ..., 3; the walk
        returns one step back toward the centre, or 0 when exhausted."""
        seg = q[3:start][::-1]  # walk order
        k = _first_true_count(seg)
        found = k < seg.shape[0]
        idx = (start - 1) - k
        return jnp.where(found, idx + 1, 0).astype(I32)

    def walk_up(q: jnp.ndarray, start: int, c_max: int) -> jnp.ndarray:
        """First qualifying index walking start+1 ... c_max; one step back,
        or c_max + 2 when exhausted."""
        seg = q[start + 1 : c_max + 1]
        k = _first_true_count(seg)
        found = k < seg.shape[0]
        idx = (start + 1) + k
        return jnp.where(found, idx - 1, c_max + 2).astype(I32)

    left = walk_down(left_q, cx)
    right = walk_up(right_q, cx, w - 3)
    top = walk_down(up_q, cy)
    bottom = walk_up(down_q, cy, h - 3)
    return jnp.stack([left, top, right, bottom])


def _edgy_quiet(map_bgra: jnp.ndarray) -> jnp.ndarray:
    """Low-edginess mask for the minimap finder.

    quiet[y,x] <=> max over the 8 neighbours of sum_BGR |a-b| <= 7, which is
    exactly `get_edginess <= 0.01` in the reference
    (src/vision/find_minimap.rs:9-46: 7/765 <= 0.01 < 8/765). Pure integer
    math -> bit-exact with the host oracle. The 1-px border is forced False
    (the walks never sample closer than 3 px from an edge)."""
    return _edgy_quiet_planes(
        map_bgra[..., 0], map_bgra[..., 1], map_bgra[..., 2]
    )


def _edgy_quiet_planes(
    p0: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray
) -> jnp.ndarray:
    """_edgy_quiet on channel planes (SAD is channel-order agnostic)."""
    planes = [p.astype(jnp.int16) for p in (p0, p1, p2)]
    h, w = planes[0].shape

    best = jnp.zeros((h - 2, w - 2), dtype=jnp.int16)
    centres = [p[1:-1, 1:-1] for p in planes]
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            d = jnp.zeros((h - 2, w - 2), dtype=jnp.int16)
            for p, c in zip(planes, centres):
                d = d + jnp.abs(c - p[dy : dy + h - 2, dx : dx + w - 2])
            best = jnp.maximum(best, d)

    quiet = best <= 7
    return jnp.pad(quiet, ((1, 1), (1, 1)), constant_values=False)


def _ocr_preprocess(brq_rgb: jnp.ndarray) -> jnp.ndarray:
    """Whiteish-text isolation (oracle: smh_tpu/vision/pixmath.py:ocr_preprocess,
    reference: vision-cpu/src/lib.rs:173-231)."""
    return _ocr_preprocess_planes(
        brq_rgb[..., 0], brq_rgb[..., 1], brq_rgb[..., 2]
    )


def _ocr_preprocess_planes(
    r8: jnp.ndarray, g8: jnp.ndarray, b8: jnp.ndarray
) -> jnp.ndarray:
    h, w = r8.shape
    r = r8.astype(jnp.int16)
    g = g8.astype(jnp.int16)
    b = b8.astype(jnp.int16)
    mono = 2 * (jnp.abs(r - g) + jnp.abs(r - b) + jnp.abs(g - b))
    mn = jnp.minimum(jnp.minimum(r8, g8), b8)

    strict = (mono <= C.OCR_PREPROCESS_MONOCHROMATICY_THRESHOLD) & (
        mn >= C.OCR_PREPROCESS_BRIGHTNESS_THRESHOLD
    )
    edge_cand = (mono <= C.OCR_PREPROCESS_SIMILARITY_EDGE_THRESHOLD) & (
        mn >= C.OCR_PREPROCESS_BRIGHTNESS_EDGE_THRESHOLD
    )

    R = C.OCR_PREPROCESS_DILATE_RADIUS
    # The reference never examines neighbours in the last R-1 columns/rows
    # (window upper bound min(x+R, w-R) inclusive, vision-cpu:201-206).
    col = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    clipped = strict & (col <= w - R) & (row <= h - R)
    near_strict = _box_dilate_bool(clipped, R)

    keep = strict | (edge_cand & near_strict)
    inv = jnp.uint8(255) - hsv.luma8_planes(r8, g8, b8)
    return jnp.where(keep, inv, jnp.uint8(255))


@jax.jit
def _red_gate_roi(btn: jnp.ndarray) -> jnp.ndarray:
    """btn: BGRA u8 [bh, bw, 4] close-button ROI -> red fraction scalar."""
    rgb = _bgra_to_rgb(btn).astype(jnp.int16)
    ok = jnp.ones(rgb.shape[:2], dtype=bool)
    for i, c in enumerate(C.CLOSE_DEPLOYMENT_BUTTON_COLOR):
        ok = ok & (jnp.abs(jnp.int16(c) - rgb[..., i]).astype(jnp.uint16) <= C.CLOSE_DEPLOYMENT_BUTTON_TOLERANCE)
    count = ok.sum(dtype=jnp.int32)
    return count.astype(F32) / F32(rgb.shape[0] * rgb.shape[1])


def red_gate(frame_dev: jax.Array) -> float:
    """Fraction of close-deployment-button ROI pixels that are button-red
    (whole-frame convenience wrapper)."""
    h, w = frame_dev.shape[:2]
    g = C.map_geometry(w, h)
    btn = jax.lax.slice(frame_dev, (g.btn_y, g.btn_x, 0), (g.btn_y + g.btn_h, g.btn_x + g.btn_w, 4))
    return float(_red_gate_roi(btn))


@functools.partial(
    jax.jit, static_argnames=("grayscale", "with_isolated")
)
def _analyze_map(
    map_bgra: jnp.ndarray,
    grayscale: bool,
    with_isolated: bool,
):
    """The fused pass over an INTERLEAVED map ROI ([h,w,4] BGRA or [h,w,3]
    BGR — the alpha byte is never read). Compatibility entry for full-frame
    callers (analyze_frame, parallel/spmd); the production flat dispatch
    feeds _analyze_map_planes directly — an interleaved u8 map makes XLA
    emit a planarizing layout copy, because every channel consumer reads
    planes."""
    b8 = map_bgra[..., 0]
    g8 = map_bgra[..., 1]
    r8 = map_bgra[..., 2]
    return _analyze_map_planes(
        b8, g8, r8, grayscale=grayscale, with_isolated=with_isolated,
    )


def _analyze_map_planes(
    b8: jnp.ndarray,
    g8: jnp.ndarray,
    r8: jnp.ndarray,
    grayscale: bool,
    with_isolated: bool,
):
    """The fused pass over the map ROI as BGR channel PLANES ([h,w] each).

    Uploading just the ROIs instead of the whole frame cuts H2D ~2.3x (the
    map is the only region the pipeline reads besides the close-button; the
    BRQ is the map's own bottom-right quadrant). The planar layout is the
    production upload format: flat plane-major bytes reshape to [3,h,w] with
    zero layout copies, and every consumer (classify, luma, OCR preprocess,
    quiet SAD) reads whole planes."""
    map_h, map_w = b8.shape

    marker = hsv.is_any_map_marker_color_planes(r8, g8, b8)

    # ui_map: what the user sees (crop_to_map, cuda.cu:354-406). Grayscale
    # travels as a single luma plane (the host expands to RGBA): 4x less D2H.
    if grayscale:
        ui = hsv.luma8_planes(r8, g8, b8)
    else:
        # Color mode re-interleaves for display (one transpose copy — only
        # paid when grayscale_map is off).
        ui = jnp.stack([r8, g8, b8], axis=-1)

    # LSD mask: the marker predicate + L1 r=1 dilate. Blackening non-marker
    # pixels (isolate_map_markers) then re-testing (mask_marker_lines) equals
    # a single predicate evaluation: black never passes the classifier.
    lsd_bool = _dilate_l1_radius1_bool(marker)
    lsd_mask = jnp.where(lsd_bool, jnp.uint8(255), jnp.uint8(0))

    brq_h, brq_w = map_h // 2, map_w // 2

    def brq(p):
        return jax.lax.slice(p, (brq_h, brq_w), (brq_h + brq_h, brq_w + brq_w))

    brq_b, brq_g, brq_r = brq(b8), brq(g8), brq(r8)

    ocr_img = _ocr_preprocess_planes(brq_r, brq_g, brq_b)
    scales_bool = hsv.luma8_planes(brq_r, brq_g, brq_b) != 0

    # Cheap device-side checksum of the ui plane: lets the host skip the
    # (expensive) D2H + web push when the visible map did not change.
    if grayscale:
        ui_flat = ui
    else:
        ui_flat = (
            r8.astype(jnp.uint32) + g8.astype(jnp.uint32) + b8.astype(jnp.uint32)
        )
    ui_check = _weighted_check(ui_flat)

    out = {
        "ui": ui,  # [h,w] luma when grayscale else [h,w,3] rgb
        "ui_check": ui_check,  # u32 [2]
        "lsd_bool": lsd_bool,  # full bool mask (windowed crop is sliced from it)
        "lsd_mask": lsd_mask,  # u8 full mask, stays device-side for the march
        "lsd_bits": pack_bits(lsd_bool),
        "scales_bits": pack_bits(scales_bool),
        "scales_bool": scales_bool,
        "ocr_img": ocr_img,
        "quiet_bool": _edgy_quiet_planes(b8, g8, r8),
    }
    if with_isolated:
        map_rgb = jnp.stack([r8, g8, b8], axis=-1)
        out["isolated_map"] = jnp.where(marker[..., None], map_rgb, jnp.uint8(0))
        out["cropped_brq"] = jnp.stack([brq_r, brq_g, brq_b], axis=-1)
    return out


# ---------------------------------------------------------------------------
# The production dispatch: fused pass + red gate with every detection-path
# output packed into ONE u8 buffer, so the pipeline performs exactly one
# fetch per frame in the common case (the display ui plane and the
# scalespack stay separate and lazy).
# ---------------------------------------------------------------------------


def hostpack_layout(
    map_h: int,
    map_w: int,
    with_ocr: bool = True,
    with_quiet: bool = True,
    crop_h: int | None = None,
    crop_w: int | None = None,
    scales_inline: str = "none",
    scales_band: int | None = None,
    sparse_budget: int | None = None,
) -> dict:
    """Byte offsets of each section inside the packed buffer.

    v2 layout. `lsd_meta` = 6 x i32 (y0, y1, x0, x1, cy0, cx0): the exact
    dilated-mask bbox (end-exclusive; empty => y0 >= y1) plus the crop window
    origin. `lsd_crop` is the bit-packed (crop_h, crop_w) window of the mask.
    with_ocr adds the 4xu32 scales checksum. with_quiet adds the 4xi32
    minimap rect, computed on device by _minimap_rect (16 bytes instead of
    the h*w/8-byte quiet mask a host-side walk would need; the driver can
    still skip it every Nth frame — bounds only move on zoom changes).

    scales_inline: *where* the scales/OCR images travel is adaptive:
      "none"   — checksum only; a changed checksum costs one lazy scalespack
                 fetch (best when the map is static: zero bytes steady-state);
      "gray"   — scales binarize bits + full grayscale OCR image inline (the
                 map is panning and the engine reads gray levels: one fetch
                 beats two);
      "binary" — scales binarize bits + bit-packed OCR *text mask* inline
                 (engines with binary_ok only threshold the image: 8x less);
      "device" — no image at all: the device reads the scales itself (glyph
                 segmentation + template matmul + bar scan, ops/scales_device)
                 and ships ~1.2 KB of fixed-shape word records. The
                 scalespack stays device-resident as the capacity-overflow
                 fallback.

    sparse_budget: when set, the mask travels SPARSE instead of as a window
    crop: the fused pass compacts the nonzero u32 words of the bit-packed
    full-map mask (searchsorted-gather) and the pack
    carries `lsd_nz` (i32 total nonzero words) + `lsd_sp_idx` (i32 flat word
    indices) + `lsd_sp_dat` (the u32 words) sized to the static budget. A
    real dilated marker mask is ~600 nonzero words at 4K (~5 KB) where the
    half-map window crop is ~150 KB. nz > budget is a transport miss: the host falls back to the
    device-resident full `lsd_bits` (exact) and escalates the budget rung.
    Reconstruction (sparse_mask_host) is exact when nz <= budget, so
    detections are bit-identical to the full-mask path.
    """
    crop_h = map_h if crop_h is None else crop_h
    crop_w = map_w if crop_w is None else crop_w
    brq_h, brq_w = map_h // 2, map_w // 2
    mask_bytes = map_h * ((map_w + 7) // 8)
    crop_bytes = crop_h * ((crop_w + 7) // 8)
    sections = [
        ("red_ratio", 4),
        ("ui_check", 8),
        ("lsd_meta", 24),
    ]
    if with_ocr:
        sections += [("scales_check", 16)]
        rows = brq_h if scales_band is None else scales_band
        row_bits = (brq_w + 7) // 8
        if scales_inline in ("binary", "gray") and scales_band is not None:
            sections += [("scales_meta", 12)]
        if scales_inline == "binary":
            sections += [("scales_bits", rows * row_bits), ("ocr_bits", rows * row_bits)]
        elif scales_inline == "gray":
            sections += [("scales_bits", rows * row_bits), ("ocr_img", rows * brq_w)]
        elif scales_inline == "device":
            from . import scales_device as _sd

            sections += [("scales_rec", _sd.REC_BYTES)]
    if with_quiet:
        sections += [("minimap_rect", 16)]
    if sparse_budget is not None:
        sections += [
            ("lsd_nz", 4),
            ("lsd_sp_idx", 4 * sparse_budget),
            ("lsd_sp_dat", 4 * sparse_budget),
        ]
    else:
        sections += [("lsd_crop", crop_bytes)]
    layout = {}
    off = 0
    for name, size in sections:
        layout[name] = (off, size)
        off += size
    layout["__total__"] = off
    return layout


# Text threshold of the binary-capable OCR engines: one definition, in the
# engine contract module (every consumer imports it from there, so the
# device bit-pack and the host engines cannot drift).
from ..ocr.engine import OCR_BINARY_THRESHOLD  # noqa: E402  (layout section)


def scales_scan_budget(brq_w: int) -> int:
    """Rows the bar scan can read below a text's bottom: the reference's
    round((20/640) * image_width) scan-down budget plus the 4-px vertical-bar
    probe (vision/mpx_ratio.py:find_scale_width). The OCR text-row band must
    extend this far past the keep-mask bbox to be read-complete."""
    return int((20.0 / 640.0) * brq_w + 0.5) + 4


def scalespack_layout(map_h: int, map_w: int) -> dict:
    """Sections of the lazily-fetched scales/OCR device buffer."""
    brq_h, brq_w = map_h // 2, map_w // 2
    scales_bytes = brq_h * ((brq_w + 7) // 8)
    ocr_bytes = brq_h * brq_w
    return {
        "scales_bits": (0, scales_bytes),
        "ocr_img": (scales_bytes, ocr_bytes),
        "__total__": scales_bytes + ocr_bytes,
    }


def _pack_outputs(
    out: dict,
    red: jnp.ndarray,
    with_ocr: bool,
    with_quiet: bool,
    crop_h: int,
    crop_w: int,
    scales_inline: str = "none",
    with_mask_output: bool = True,
    scales_band: int | None = None,
    sparse_budget: int | None = None,
) -> dict:
    map_h, map_w = out["lsd_bool"].shape
    y0, y1, x0, x1 = _mask_bbox(out["lsd_bool"])
    margin = jnp.int32(LSD_CROP_MARGIN)
    if sparse_budget is not None:
        # Sparse transport: no window — the whole (bit-packed) plane is
        # reconstructable from the compacted nonzero words, so the crop
        # origin is the plane origin.
        cy0 = jnp.int32(0)
        cx0 = jnp.int32(0)
    else:
        cy0 = jnp.clip(y0 - margin, 0, map_h - crop_h)
        cx0 = jnp.clip(x0 - margin, 0, map_w - crop_w)
        crop = jax.lax.dynamic_slice(out["lsd_bool"], (cy0, cx0), (crop_h, crop_w))

    red_u8 = jax.lax.bitcast_convert_type(red[None], jnp.uint8).reshape(-1)
    check_u8 = jax.lax.bitcast_convert_type(out["ui_check"], jnp.uint8).reshape(-1)
    meta = jnp.stack([y0, y1, x0, x1, cy0, cx0]).astype(jnp.int32)
    meta_u8 = jax.lax.bitcast_convert_type(meta, jnp.uint8).reshape(-1)
    parts = [red_u8, check_u8, meta_u8]
    if with_ocr:
        scheck = jnp.concatenate([_weighted_check(out["scales_bits"]), _weighted_check(out["ocr_img"])])
        parts += [jax.lax.bitcast_convert_type(scheck, jnp.uint8).reshape(-1)]
        banded = scales_inline in ("binary", "gray") and scales_band is not None
        if banded:
            # OCR text-row band: every non-background OCR pixel lives in the
            # keep-mask row bbox, and the bar scan reads at most
            # scales_scan_budget rows below a text bottom — so a row band
            # anchored at the bbox is a read-complete (exact) transport.
            brq_h, brq_w = out["ocr_img"].shape
            keep = out["ocr_img"] < jnp.uint8(OCR_BINARY_THRESHOLD)
            krows = keep.any(axis=1)
            oy0 = _first_true_count(krows)
            oy1 = jnp.int32(brq_h) - _first_true_count(krows[::-1])
            b0 = jnp.clip(oy0, 0, brq_h - scales_band)
            smeta = jnp.stack([oy0, oy1, b0]).astype(jnp.int32)
            parts += [jax.lax.bitcast_convert_type(smeta, jnp.uint8).reshape(-1)]
            row_bits = (brq_w + 7) // 8
            sb_band = jax.lax.dynamic_slice(
                out["scales_bits"], (b0, 0), (scales_band, row_bits)
            )
            if scales_inline == "binary":
                ob_band = jax.lax.dynamic_slice(
                    pack_bits(keep), (b0, 0), (scales_band, row_bits)
                )
                parts += [sb_band.reshape(-1), ob_band.reshape(-1)]
            else:
                oi_band = jax.lax.dynamic_slice(
                    out["ocr_img"], (b0, 0), (scales_band, brq_w)
                )
                parts += [sb_band.reshape(-1), oi_band.reshape(-1)]
        elif scales_inline == "binary":
            parts += [
                out["scales_bits"].reshape(-1),
                pack_bits(out["ocr_img"] < jnp.uint8(OCR_BINARY_THRESHOLD)).reshape(-1),
            ]
        elif scales_inline == "gray":
            parts += [out["scales_bits"].reshape(-1), out["ocr_img"].reshape(-1)]
        elif scales_inline == "device":
            from . import scales_device as _sd

            rec = _sd.scales_records(
                out["ocr_img"] < jnp.uint8(OCR_BINARY_THRESHOLD),
                out["scales_bool"],
                jnp.asarray(_sd.device_templates()),
            )
            parts += [jax.lax.bitcast_convert_type(rec, jnp.uint8).reshape(-1)]
    if with_quiet:
        rect = _minimap_rect(out["quiet_bool"])
        parts += [jax.lax.bitcast_convert_type(rect, jnp.uint8).reshape(-1)]
    if sparse_budget is not None:
        nz, sp_idx, sp_dat = _sparse_words(out["lsd_bool"], sparse_budget)
        parts += [
            jax.lax.bitcast_convert_type(nz[None], jnp.uint8).reshape(-1),
            jax.lax.bitcast_convert_type(sp_idx, jnp.uint8).reshape(-1),
            jax.lax.bitcast_convert_type(sp_dat, jnp.uint8).reshape(-1),
        ]
    else:
        parts += [pack_bits(crop).reshape(-1)]
    pack = jnp.concatenate(parts)

    # Only materialize device outputs a consumer can actually reach: every
    # extra output is HBM writeback on each dispatch (the u8 full mask alone
    # is h*w bytes). "lsd_mask" feeds the device ray-march engine and debug;
    # the scalespack exists only for the lazy (inline="none") transport.
    res = {
        "hostpack": pack,
        "ui": out["ui"],
        "lsd_bits": out["lsd_bits"],  # full mask: window-miss fallback fetch
    }
    if with_mask_output:
        res["lsd_mask"] = out["lsd_mask"]
    if with_ocr and (
        scales_inline in ("none", "device") or scales_band is not None
    ):
        # The full-resolution images: the lazy transport's payload, and the
        # band/device transports' fallback (band misses; device capacity
        # overflow with no trusted read).
        res["scalespack"] = jnp.concatenate(
            [out["scales_bits"].reshape(-1), out["ocr_img"].reshape(-1)]
        )
    return res


def _analyze_flat_core(
    rois: jnp.ndarray,
    map_h: int,
    map_w: int,
    btn_h: int,
    btn_w: int,
    grayscale: bool,
    with_ocr: bool = True,
    with_quiet: bool = True,
    crop_h: int | None = None,
    crop_w: int | None = None,
    scales_inline: str = "none",
    with_mask_output: bool = True,
    channels: int = 4,
    scales_band: int | None = None,
    sparse_budget: int | None = None,
):
    """Shared body of the flat-upload dispatch variants: slices both ROIs out
    of one flat u8 buffer (any bytes past map+btn — chunk padding — are
    ignored) and runs the fused pass + red gate + hostpack packing.

    channels==3 is the production format: the MAP bytes are PLANE-MAJOR
    (B plane, G plane, R plane — _pack_rois_bgr packs them that way), so the
    reshape to [3, map_h, map_w] is layout-free. An interleaved [h,w,3] map
    would force XLA to planarize it for the channel consumers — a full
    layout copy of the ROI. The (small) button ROI stays interleaved. channels==4 keeps the
    legacy interleaved-BGRA contract."""
    crop_h = map_h if crop_h is None else crop_h
    crop_w = map_w if crop_w is None else crop_w
    map_bytes = map_h * map_w * channels
    btn_bgra = rois[map_bytes : map_bytes + btn_h * btn_w * channels].reshape(btn_h, btn_w, channels)
    if channels == 3:
        planes = rois[:map_bytes].reshape(3, map_h, map_w)
        out = _analyze_map_planes(
            planes[0], planes[1], planes[2], grayscale=grayscale,
            with_isolated=False,
        )
    else:
        map_bgra = rois[:map_bytes].reshape(map_h, map_w, channels)
        out = _analyze_map(
            map_bgra, grayscale=grayscale, with_isolated=False,
        )
    red = _red_gate_roi(btn_bgra)
    return _pack_outputs(
        out, red, with_ocr, with_quiet, crop_h, crop_w, scales_inline,
        with_mask_output=with_mask_output, scales_band=scales_band,
        sparse_budget=sparse_budget,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "map_h", "map_w", "btn_h", "btn_w",
        "grayscale", "with_ocr", "with_quiet", "crop_h", "crop_w",
        "scales_inline", "with_mask_output", "channels", "scales_band",
        "sparse_budget", "with_resident",
    ),
)
def _analyze_packed_flat(
    rois: jnp.ndarray,
    map_h: int,
    map_w: int,
    btn_h: int,
    btn_w: int,
    grayscale: bool,
    with_ocr: bool = True,
    with_quiet: bool = True,
    crop_h: int | None = None,
    crop_w: int | None = None,
    scales_inline: str = "none",
    with_mask_output: bool = True,
    channels: int = 4,
    scales_band: int | None = None,
    sparse_budget: int | None = None,
    with_resident: bool = False,
):
    """The production full-upload dispatch: takes BOTH ROIs in one flat u8
    upload (one transfer instead of two; channels=3 drops the unused alpha
    byte for 25% fewer upload bytes); returns the hostpack plus the
    device-resident lazy outputs. The caller passes the HOST buffer
    directly: the transfer rides the call instead of a separate device_put.
    with_resident=True echoes the uploaded buffer back as a device output,
    seeding the delta-transport chain."""
    out = _analyze_flat_core(
        rois, map_h, map_w, btn_h, btn_w, grayscale,
        with_ocr=with_ocr, with_quiet=with_quiet, crop_h=crop_h, crop_w=crop_w,
        scales_inline=scales_inline,
        with_mask_output=with_mask_output, channels=channels,
        scales_band=scales_band, sparse_budget=sparse_budget,
    )
    if with_resident:
        out["resident"] = rois
    return out


@functools.partial(
    jax.jit,
    static_argnames=(
        "bucket", "chunk",
        "map_h", "map_w", "btn_h", "btn_w",
        "grayscale", "with_ocr", "with_quiet", "crop_h", "crop_w",
        "scales_inline", "with_mask_output", "channels", "scales_band",
        "sparse_budget",
    ),
)
def _analyze_delta_flat(
    resident: jnp.ndarray,  # u8 [padded_total] device-resident ROI buffer
    buf: jnp.ndarray,  # u8 [4*bucket + bucket*chunk] delta upload
    bucket: int,
    chunk: int,
    map_h: int,
    map_w: int,
    btn_h: int,
    btn_w: int,
    grayscale: bool,
    with_ocr: bool = True,
    with_quiet: bool = True,
    crop_h: int | None = None,
    crop_w: int | None = None,
    scales_inline: str = "none",
    with_mask_output: bool = True,
    channels: int = 4,
    scales_band: int | None = None,
    sparse_budget: int | None = None,
):
    """Delta-upload dispatch: the ROI buffer stays DEVICE-RESIDENT across
    frames and the per-frame H2D carries only the chunks whose bytes changed
    (index table + chunk data in one flat upload). The scatter reconstructs
    the exact new frame before the fused pass runs, so detections are
    bit-identical to a full upload — this is the reference's crc32
    duplicate-frame skip (src/capture.rs:44-47) extended to sub-frame
    granularity (a full 4K ROI is ~9.8 MB; a typical live-play frame change
    is a few hundred KB). Index padding repeats a real index with identical
    data, so duplicate scatter writes are value-identical (deterministic).
    Returns the analyze outputs plus "resident" = the updated flat buffer
    (the next frame's chain input)."""
    idx = jax.lax.bitcast_convert_type(buf[: 4 * bucket].reshape(bucket, 4), I32)
    data = buf[4 * bucket :].reshape(bucket, chunk)
    new2d = resident.reshape(-1, chunk).at[idx].set(data)
    rois = new2d.reshape(-1)
    out = _analyze_flat_core(
        rois, map_h, map_w, btn_h, btn_w, grayscale,
        with_ocr=with_ocr, with_quiet=with_quiet, crop_h=crop_h, crop_w=crop_w,
        scales_inline=scales_inline,
        with_mask_output=with_mask_output, channels=channels,
        scales_band=scales_band, sparse_budget=sparse_budget,
    )
    out["resident"] = rois
    return out


@functools.partial(
    jax.jit,
    static_argnames=("grayscale", "with_ocr", "with_quiet", "crop_h", "crop_w"),
)
def _analyze_packed(
    map_bgra: jnp.ndarray,
    btn_bgra: jnp.ndarray,
    grayscale: bool,
    with_ocr: bool = True,
    with_quiet: bool = True,
    crop_h: int | None = None,
    crop_w: int | None = None,
):
    """Two-ROI variant (kept for tests / non-flat callers)."""
    map_h, map_w = map_bgra.shape[:2]
    crop_h = map_h if crop_h is None else crop_h
    crop_w = map_w if crop_w is None else crop_w
    out = _analyze_map(map_bgra, grayscale=grayscale, with_isolated=False)
    red = _red_gate_roi(btn_bgra)
    return _pack_outputs(out, red, with_ocr, with_quiet, crop_h, crop_w)


@functools.partial(
    jax.jit,
    static_argnames=(
        "bucket", "chunk",
        "map_h", "map_w", "btn_h", "btn_w", "grayscale", "with_ocr",
        "crop_h", "crop_w", "scales_inline", "channels", "sparse_budget",
    ),
)
def _analyze_batch_delta(
    resident: jnp.ndarray,  # u8 [padded_total] chain state (last analyzed frame)
    buf: jnp.ndarray,  # u8 [B*bucket*4 idx][B*bucket*chunk data]
    bucket: int,
    chunk: int,
    map_h: int,
    map_w: int,
    btn_h: int,
    btn_w: int,
    grayscale: bool,
    with_ocr: bool = True,
    crop_h: int | None = None,
    crop_w: int | None = None,
    scales_inline: str = "none",
    channels: int = 4,
    sparse_budget: int | None = None,
):
    """Batched delta pass: B frames expressed as chunk-updates against a
    device-resident chain (frame i diffs against frame i-1; frame 0 against
    the previous batch's tail), applied and analyzed by ONE lax.scan — one
    dispatch, one fetch, and H2D proportional to inter-frame motion instead
    of B full ROI buffers. This is the video/throughput configuration: for
    typical footage consecutive frames share most content, so the upload
    shrinks 5-50x. Semantics are identical to _analyze_batch_packed (the
    scatter reconstructs each frame's exact bytes before the fused pass).
    Returns stacked hostpacks/lsd_bits plus the new chain tail."""
    n_total = resident.size // chunk
    b = buf.size // (4 * bucket + bucket * chunk)
    idxs = jax.lax.bitcast_convert_type(
        buf[: 4 * bucket * b].reshape(b, bucket, 4), I32
    )
    datas = buf[4 * bucket * b :].reshape(b, bucket, chunk)

    with_spack = with_ocr and scales_inline in ("none", "device")

    def step(res2d, upd):
        idx, data = upd
        new2d = res2d.at[idx].set(data)
        out = _analyze_flat_core(
            new2d.reshape(-1), map_h, map_w, btn_h, btn_w, grayscale,
            with_ocr=with_ocr, with_quiet=True, crop_h=crop_h, crop_w=crop_w,
            scales_inline=scales_inline,
            with_mask_output=False, channels=channels,
            sparse_budget=sparse_budget,
        )
        extras = (out["scalespack"],) if with_spack else ()
        return new2d, (out["hostpack"], out["lsd_bits"]) + extras

    res2d, outs = jax.lax.scan(
        step, resident.reshape(n_total, chunk), (idxs, datas)
    )
    res = {"hostpack": outs[0], "lsd_bits": outs[1], "resident": res2d.reshape(-1)}
    if with_spack:
        res["scalespack"] = outs[2]
    return res


@functools.partial(
    jax.jit,
    static_argnames=(
        "map_h", "map_w", "btn_h", "btn_w", "grayscale", "with_ocr", "crop_h", "crop_w",
        "scales_inline", "channels", "resident_row", "sparse_budget",
    ),
)
def _analyze_batch_packed(
    rois: jnp.ndarray,  # u8 [B, roi_bytes]
    map_h: int,
    map_w: int,
    btn_h: int,
    btn_w: int,
    grayscale: bool,
    with_ocr: bool = True,
    crop_h: int | None = None,
    crop_w: int | None = None,
    scales_inline: str = "none",
    channels: int = 4,
    resident_row: int | None = None,
    sparse_budget: int | None = None,
):
    """Batched fused pass: B frames in, ONE [B, pack_bytes] hostpack out.

    This is the throughput mode: the per-frame dispatch and fetch cost
    divides by B (SURVEY/BASELINE config "streaming
    capture loop with batched frames"). The windowed LSD crop applies per
    frame (vmapped dynamic_slice, per-frame origins); scalespacks come back
    as one [B, bytes] array fetched only when some frame's checksum missed.
    resident_row echoes that row of the upload back as a device output —
    it seeds the batch delta chain (_analyze_batch_delta) with the last
    real frame of this batch."""

    def one(roi):
        out = _analyze_packed_flat(
            roi,
            map_h=map_h,
            map_w=map_w,
            btn_h=btn_h,
            btn_w=btn_w,
            grayscale=grayscale,
            with_ocr=with_ocr,
            crop_h=crop_h,
            crop_w=crop_w,
            scales_inline=scales_inline,
            with_mask_output=False,
            channels=channels,
            sparse_budget=sparse_budget,
        )
        if with_ocr and scales_inline in ("none", "device"):
            return out["hostpack"], out["lsd_bits"], out["scalespack"]
        return out["hostpack"], out["lsd_bits"]

    outs = jax.vmap(one)(rois)
    res = {"hostpack": outs[0], "lsd_bits": outs[1]}
    if with_ocr and scales_inline in ("none", "device"):
        res["scalespack"] = outs[2]
    if resident_row is not None:
        res["resident"] = rois[resident_row]
    return res


def analyze_map(
    map_dev: jax.Array, grayscale: bool = True, with_isolated: bool = False
) -> dict:
    """Run the fused pass over a BGRA u8 map-ROI device array."""
    return _analyze_map(map_dev, grayscale=grayscale, with_isolated=with_isolated)


@functools.partial(jax.jit, static_argnames=("grayscale", "with_isolated"))
def analyze_map_planar(
    planes: jax.Array, grayscale: bool = True, with_isolated: bool = False
) -> dict:
    """Fused pass over a PLANE-MAJOR BGR u8 [3, h, w] map ROI (the
    production resident layout; debug re-dispatch uses this to read the
    resident buffer without a layout copy)."""
    return _analyze_map_planes(
        planes[0], planes[1], planes[2], grayscale=grayscale,
        with_isolated=with_isolated,
    )


def analyze_frame(
    frame_dev: jax.Array, grayscale: bool = True, with_isolated: bool = False
) -> dict:
    """Whole-frame convenience wrapper: slices the map ROI on device, then
    runs the fused pass (used by the batch/multi-chip path, which keeps whole
    frames sharded on device)."""
    h, w = frame_dev.shape[:2]
    g = C.map_geometry(w, h)
    map_bgra = jax.lax.slice(
        frame_dev, (g.map_y, g.map_x, 0), (g.map_y + g.map_h, g.map_x + g.map_w, 4)
    )
    return _analyze_map(map_bgra, grayscale=grayscale, with_isolated=with_isolated)


def trace_census() -> dict:
    """How many traces (jit buckets) each entry point compiled in THIS
    process — the cold-start bill, itemized. bench.py records it so rung/
    band/flag ladder growth shows up as a number in the JSON of record
    instead of as an unexplained first-run stall (every bucket is a compile
    on a cold persistent cache)."""
    out = {}
    for fn in (
        _analyze_packed_flat, _analyze_delta_flat,
        _analyze_batch_packed, _analyze_batch_delta,
        _analyze_map, _red_gate_roi, unpack_bits_device,
    ):
        try:
            out[fn.__name__] = fn._cache_size()
        except Exception:  # pragma: no cover - private API moved
            pass
    return out
