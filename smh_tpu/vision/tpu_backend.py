"""Device vision backend: the production counterpart of the numpy oracle.

Implements the same backend contract as ReferenceBackend (mirroring the
`Vision` trait, /root/reference/vision-common/src/lib.rs:30-61) on top of the
fused JAX ops in smh_tpu.ops. Where the reference GPU backend launches one
CUDA kernel per stage across 4 streams (vision-gpu/src/lib.rs:207-479), this
backend runs the entire elementwise DAG in ONE jitted dispatch when
crop_to_map is called; the later stage methods only consume cached results,
so the trait-shaped API is preserved without giving up fusion.

Host<->device traffic (the H2D/D2H boundaries of SURVEY.md section 3.1):
  * one H2D per frame (flat upload of the map+button ROIs);
  * ONE critical-path D2H per frame: the hostpack (red gate, checksums, LSD
    bbox + the sparse word sections, minimap rect on quiet-cadence frames);
  * lazy D2H: the ui plane (display only, checksum-deduped) and the
    scalespack (OCR image + scales binarize) fetched only when the device
    checksum says its content changed. The reference instead pins and
    transfers the OCR and LSD images every frame
    (vision-gpu/src/gpuimage.rs:117-167).

The LSD mask transport adapts. Default (round 3+): SPARSE — the fused pass
compacts the nonzero u32 words of the bit-packed plane (a real 4K marker
mask is ~600 words / ~5 KB where a half-map window crop is ~150 KB), over a
word-budget rung ladder (escalate immediately on overflow — that frame falls
back to fetching the full bit-mask, kept device-resident — shrink after a
sustained fitting streak). SMH_SPARSE=0 reverts to the round-2 WINDOW
transport: a 2-D rung ladder (1/16..full per dimension) sized per frame from
the device-computed mask bbox. Both are exact: sparse reconstruction is the
full plane bit-for-bit; crop-local detection is bit-identical to full-mask
detection because the window carries LSD_CROP_MARGIN black context
(>= max_gap + 2 ray death, >= centre-snap radius).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import jax
import numpy as np

from .. import consts as C
from ..geometry import Line, Point
from ..ops import lsd as ops_lsd
from ..ops import pipeline as ops_pipeline
from ..ops import scales_device as ops_scales_device
from . import lsd
from .reference import DebugView

# Maps whose full bit-mask is at most this many bytes skip the windowing
# machinery entirely (tiny test frames; the crop would not pay for itself).
_MIN_WINDOWED_MASK_BYTES = 16 * 1024
# Extra headroom the next frame's window must have over this frame's bbox
# (marker lines grow under the player's drag).
_RUNG_SLACK = 64
# Consecutive comfortably-fitting frames before the window shrinks a rung.
_SHRINK_AFTER = 30
# The OCR text band shrinks faster: scale-label text height is fixed UI
# chrome, so a short stable streak suffices (a wrong guess costs one
# fallback fetch + immediate re-escalation, not a detection error).
_BAND_SHRINK_AFTER = 5
# Consecutive unchanged scales checksums before the scales/OCR images drop
# out of the inline hostpack (static map -> checksum-only transport).
_INLINE_STABLE_AFTER = 3


try:  # SIMD BGRA->BGR (~3 ms for a 13 MB 4K ROI vs ~17 ms strided numpy)
    import cv2 as _cv2
except Exception:  # pragma: no cover - cv2 is in the image, but stay optional
    _cv2 = None

ROI_CHANNELS = 3  # the alpha byte is never read; dropping it cuts H2D 25%

# -- delta H2D transport ------------------------------------------------------
# The ROI buffer stays device-resident; per-frame H2D ships only the chunks
# whose bytes changed (exact reconstruction via scatter — see
# ops/pipeline._analyze_delta_flat). A full 4K upload is 9.8 MB; a typical
# live-play change (marker drag, UI tick) is a few hundred KB.
_DELTA_CHUNK = 128  # DIFF granularity, bytes (u64-view [n,16] compare)
_DELTA_SUB = 32  # UPLOAD granularity, bytes. Two-level: diff at 128 B, then
# refine the changed chunks to 32 B sub-chunks by re-reading the SAME
# elementwise compare (zero extra passes). The planar layout spreads a
# changed region across 3 plane runs, so 128 B rounding wastes ~2x upload
# bytes (measured 270 KB/frame on the 4K drag workload; 32 B sub-chunks
# carry the same content in ~76 KB).
_DELTA_MIN_BYTES = 1 << 20  # below this a full upload is already cheap
_DELTA_MAX_FRACTION = 0.5  # more change than this -> full upload (panning)
# Chunk-count buckets: each bucket is its own jit trace, so the ladder
# trades upload padding for a bounded compile count (only the 1-2 buckets a
# scene actually visits ever compile). x2 steps below 512 chunks (padding
# there is cheap); 1.5x-spaced intermediates above, where the planar
# layout's 3-plane chunk spread parks video workloads just over power-of-2
# edges. Counts are in _DELTA_SUB units since the two-level refine (a 4K
# drag is ~2 K sub-chunks ~ 72 KB on the 2048 bucket).
_DELTA_BUCKETS = tuple(
    sorted({16 << i for i in range(14)} | {48 << i for i in range(4, 13)})
)


def _prefetch_mode() -> bool:
    return os.environ.get("SMH_PREFETCH", "1") != "0"


def start_fetch(arr) -> None:
    """Begin the D2H of a jit output WITHOUT waiting for it.

    `copy_to_host_async` starts the transfer as soon as the program's output
    exists and it completes in the BACKGROUND, overlapping host work and
    other transfers; a later np.asarray on the completed copy only reads
    host memory. The per-frame fetch thereby overlaps whatever host work
    (pack/diff of the next frame, LSD scan of the previous one) runs between
    dispatch and consume."""
    if not _prefetch_mode():  # SMH_PREFETCH=0: A/B the eager-copy effect
        return
    try:
        arr.copy_to_host_async()
    except Exception:  # pragma: no cover - sharded/committed corner cases
        pass


def wait_ready(arr, poll_s: float = 0.0005, force_after_s: float = 60.0) -> None:
    """Block until a jit output is materialized, by polling the local
    `is_ready()` check instead of fetching data. Falls back to a forcing
    fetch if readiness never flips within `force_after_s`."""
    import time as _time

    deadline = _time.monotonic() + force_after_s
    try:
        while not arr.is_ready():
            _time.sleep(poll_s)
            if _time.monotonic() > deadline:  # pragma: no cover - stall
                np.asarray(arr if arr.ndim == 0 else arr.ravel()[:1])
                return
    except AttributeError:  # pragma: no cover - non-jax array
        pass


def _refine_subchunks(ne: "np.ndarray", changed: "np.ndarray") -> "np.ndarray":
    """Two-level delta refine: given the u64-view elementwise compare
    `ne` [n_chunks, words] and the changed 128 B chunk indices, return the
    changed 32 B sub-chunk indices — re-reading the SAME compare, so the
    refine costs no extra passes. Shared by the per-frame backend and the
    batch chain (their transports must never diverge)."""
    sub = _DELTA_CHUNK // _DELTA_SUB
    if changed.size == 0:
        return np.zeros(1, dtype=np.int32)  # flags may still differ
    d32 = ne[changed].reshape(changed.size, sub, -1).any(axis=2)
    return (changed[:, None] * sub + np.arange(sub, dtype=np.int32))[d32]


def _delta_bucket(n: int, n_chunks: int) -> Optional[int]:
    """Smallest ladder bucket holding n changed chunks, or None when the
    bucketed upload would not materially undercut a full upload."""
    for b in _DELTA_BUCKETS:
        if n <= b:
            if b >= n_chunks * _DELTA_MAX_FRACTION:
                return None
            return b
    return None


def _pack_rois_bgr(
    map_roi: np.ndarray, btn_roi: np.ndarray, pad_to: int = 0,
    out: "np.ndarray | None" = None,
) -> np.ndarray:
    """Flatten both BGRA ROI views into one u8 upload buffer: the MAP as
    PLANE-MAJOR BGR (B plane, then G, then R), the (small) button ROI
    interleaved BGR. The planar map is why the device pass has no layout
    copies: XLA's channel consumers all read planes, and an interleaved
    [h,w,3] device array costs a full planarizing copy. Host-side the split
    is one cv2.mixChannels pass (~SIMD memcpy per plane). Fresh buffer per
    frame (device_put reads host memory lazily). pad_to > 0 rounds the
    buffer up to a multiple of pad_to with zeroed tail bytes (the delta
    transport's chunk grid; the fused pass never reads past map+btn)."""
    mh, mw = map_roi.shape[:2]
    bh, bw = btn_roi.shape[:2]
    msz = mh * mw
    used = msz * 3 + bh * bw * 3
    total = used if pad_to <= 0 else ((used + pad_to - 1) // pad_to) * pad_to
    # `out` recycles a retired buffer (delta-path mirrors only — a buffer a
    # full upload handed to device_put must NEVER be rewritten: the device
    # reads host memory lazily and would tear). A fresh np.empty page-faults
    # its 18.7 MB at 4K on first touch (~2-3 ms/frame of kernel time).
    if out is not None and out.size == total:
        packed = out
    else:
        packed = np.empty(total, dtype=np.uint8)
    packed[used:] = 0
    planes = [packed[c * msz : (c + 1) * msz].reshape(mh, mw) for c in range(3)]
    bdst = packed[msz * 3 : used].reshape(bh, bw, 3)
    _split_planes(map_roi, planes)
    if _cv2 is not None:
        _cv2.cvtColor(btn_roi, _cv2.COLOR_BGRA2BGR, dst=bdst)
    else:
        bdst[...] = btn_roi[..., :3]
    return packed


_scratch_planes: dict = {}


def _split_planes(roi: np.ndarray, planes: list) -> None:
    """Write roi's first three channels into the three plane views.
    cv2.split into caller views (+ a cached scratch for alpha) was the
    fastest of cv2's planarizers (split, mixChannels, extractChannel x3)."""
    if _cv2 is None:
        for c in range(3):
            planes[c][...] = roi[..., c]
        return
    nch = roi.shape[2]
    if nch == 3:
        _cv2.split(roi, planes)
        return
    if nch != 4:  # unexpected layout: plain strided copies
        for c in range(3):
            planes[c][...] = roi[..., c]
        return
    # Scratch receives the (discarded) alpha plane. Concurrent packers may
    # share one scratch — racy writes are fine, the data is never read.
    key = roi.shape[:2]
    scratch = _scratch_planes.get(key)
    if scratch is None:
        if len(_scratch_planes) > 8:
            _scratch_planes.clear()
        scratch = _scratch_planes[key] = np.empty(key, dtype=np.uint8)
    _cv2.split(roi, planes + [scratch])


def _paste_band(band_img: "np.ndarray", brq_h: int, b0: int, fill: int) -> "np.ndarray":
    """Row band -> full-height canvas. Exact: every pixel the OCR engine or
    the bar scan can read lies inside the band (the keep-mask row bbox plus
    ops/pipeline.scales_scan_budget)."""
    canvas = np.full((brq_h, band_img.shape[1]), np.uint8(fill))
    canvas[b0 : b0 + band_img.shape[0]] = band_img
    return canvas


def _ocr_image_from_host(host: dict, g) -> "np.ndarray | None":
    """OCR input from the inline hostpack sections; None -> use scalespack."""
    band = host.get("scales_band")
    if band == "miss":
        return None
    if isinstance(band, tuple) and band[2]:  # textless: all background
        return np.full((g.brq_h, g.brq_w), np.uint8(255))
    if "ocr_img_inline" in host:
        img = host["ocr_img_inline"]
        return _paste_band(img, g.brq_h, band[1], 255) if isinstance(band, tuple) else img
    if "ocr_bits_inline" in host:
        img = ops_pipeline.binary_ocr_image_host(host["ocr_bits_inline"], g.brq_w)
        return _paste_band(img, g.brq_h, band[1], 255) if isinstance(band, tuple) else img
    return None


def _scales_image_from_host(host: dict, g) -> "np.ndarray | None":
    """Scales binarize (0/255) from the inline sections; None -> scalespack."""
    band = host.get("scales_band")
    if band == "miss":
        return None
    if isinstance(band, tuple) and band[2]:  # textless: nothing readable
        return np.zeros((g.brq_h, g.brq_w), dtype=np.uint8)
    if "scales_bits_inline" in host:
        img = ops_pipeline.unpack_bits_host(host["scales_bits_inline"], g.brq_w) * np.uint8(255)
        return _paste_band(img, g.brq_h, band[1], 0) if isinstance(band, tuple) else img
    return None


def _dim_ladder(dim: int) -> list[int]:
    """Window rungs for ONE dimension: 1/16, 1/8, 1/4, 1/2, 3/4, full.
    Height and width adapt independently (marker-line sets are usually
    wide-short or tall-narrow, so a square window wastes half the crop
    bytes). The sub-1/4 rungs matter in live play: a single short marker
    line or a small text band fits in 1/16-1/8 of the dimension, and D2H
    bytes scale with the window area."""
    return [
        max(1, dim // 16), max(1, dim // 8), max(1, dim // 4),
        max(1, dim // 2), max(1, (dim * 3) // 4), dim,
    ]


_RUNG_HALF = 3  # ladder index of the dim//2 rung (the starting window)

# -- sparse mask transport -----------------------------------------------------
# Production default: the LSD mask travels as its compacted nonzero u32 words
# (ops/pipeline._sparse_words) instead of a window crop. A real dilated marker
# mask is ~600 nonzero words at 4K (~5 KB at 8 bytes/word) where the half-map
# window is ~150 KB — and the sparse pack needs no 2-D window ladder, so a
# session compiles ~1 fused-pass bucket instead of one per (rung_h, rung_w).
# nz > budget is a miss: that frame falls back to the device-resident full
# bit-mask fetch (exact) and the budget rung escalates. SMH_SPARSE=0 opts out
# (back to the window-crop transport).
_SPARSE_BUDGETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
_SP_RUNG_DEFAULT = 2  # 1024 words: ~8 KB pack section, fits live play 10x over
# Escalation headroom: marker lines grow under the player's drag; sizing the
# next rung to 5/4 of this frame's word count avoids boundary flapping.
_SP_SLACK_NUM, _SP_SLACK_DEN = 5, 4
# Consecutive sparse misses before the transport concedes the session content
# is dense and steps aside for the window ladder (re-probed later).
_SP_OFF_AFTER = 3
# Highest rung PROACTIVE (no-miss) escalation may reach = the top of the
# neighbourhood ops/warmup compiles; keeps guess-driven escalation from
# paying a mid-session jit. Actual misses may still step past it.
_SP_WARM_MAX = _SP_RUNG_DEFAULT + 2


def _sparse_mode() -> bool:
    return os.environ.get("SMH_SPARSE", "1") != "0"


class _AdaptState:
    """Cross-frame transport adaptation + display caches, SHARED by reference
    between the backend and its consume views (snapshot_job returns a shallow
    copy of the backend: per-frame fields diverge, this object does not, so a
    rung escalated while consuming frame N shapes frame N+1's dispatch even
    when N+1 is submitted from another thread). Field writes are single ints/
    bools/refs — benign under the GIL; consume owns the adaptation writes,
    submit only reads."""

    __slots__ = (
        "ui_check", "ui_map_cache", "ladder_h", "ladder_w",
        "rung_h", "rung_w", "shrink_streak",
        "sp_rung", "sp_streak", "sp_miss_streak", "sp_probation",
        "scales_inline", "scales_last_check", "scales_stable",
        "band_rung", "band_streak", "band_probation",
        "disp_seq", "mat_seq",
    )

    def __init__(self) -> None:
        self.ui_check: Optional[tuple] = None
        self.ui_map_cache: Optional[np.ndarray] = None
        self.ladder_h: Optional[list[int]] = None
        self.ladder_w: Optional[list[int]] = None
        self.rung_h = _RUNG_HALF  # start at the 1/2 window
        self.rung_w = _RUNG_HALF
        self.shrink_streak = 0
        # Sparse mask transport rung ladder (see _SPARSE_BUDGETS).
        self.sp_rung = _SP_RUNG_DEFAULT
        self.sp_streak = 0  # comfortably-fitting frames (shrink hysteresis)
        self.sp_miss_streak = 0  # consecutive misses (dense-content detector)
        self.sp_probation = 0  # frames since sparse stepped aside
        # Adaptive inline transport for the scales/OCR images.
        self.scales_inline = True
        self.scales_last_check = None
        self.scales_stable = 0
        # OCR text-row band rung ladder over brq_h.
        self.band_rung = _RUNG_HALF
        self.band_streak = 0
        self.band_probation = 0
        # Delta-chain materialization tracking (the per-frame twin of
        # BatchPipeline._seq/_fetched_seq): disp_seq counts dispatches,
        # mat_seq the highest dispatch whose hostpack fetch completed (all
        # outputs of a program materialize together, so its resident is
        # known-live). Their gap bounds the un-materialized scan-over-scan
        # chain depth in flight.
        self.disp_seq = 0
        self.mat_seq = 0


def _shared_field(name: str) -> property:
    """Backend attribute delegating to the shared _AdaptState (keeps the
    historical `backend._sp_rung`-style surface tests and warmup use)."""

    def get(self):
        return getattr(self._adapt, name)

    def set(self, value):
        setattr(self._adapt, name, value)

    return property(get, set)


def require_accelerator() -> None:
    """Refuse to run the device backend on XLA:CPU unless `jax_platforms`
    names the CPU explicitly (the test configuration). Without this, a host
    whose accelerator failed to initialise would silently run the device
    pipeline on the CPU."""
    platform = jax.devices()[0].platform
    requested = (jax.config.jax_platforms or "").split(",")
    if platform == "cpu" and "cpu" not in requested:
        raise RuntimeError(
            "device backend: JAX found no accelerator (platform 'cpu'); set "
            "JAX_PLATFORMS=cpu to run it on the CPU deliberately"
        )


class TpuBackend:
    name = "tpu"

    def __init__(self, lsd_engine: str = "auto") -> None:
        """lsd_engine: "native" (C++ host march), "tpu" (batched device
        march), or "auto" (native when the toolchain built it, else tpu).
        Both reproduce the oracle's semantics; native is the faster host path
        for this scalar-chasing workload (SURVEY.md section 7 "hard parts")."""
        require_accelerator()
        self.frame_np: Optional[np.ndarray] = None
        self.rois_dev: Optional[jax.Array] = None  # packed map+btn ROI upload
        self.geom: Optional[C.MapGeometry] = None
        self._results: Optional[dict] = None
        self._lsd_crop_host: Optional[np.ndarray] = None  # u8 0/255 crop
        self._lsd_offset: tuple[int, int] = (0, 0)  # (x, y) of crop in map
        self._march_max_len: Optional[float] = None  # bbox diag bound
        self._job_seq = 0  # this frame's dispatch seq (chain-depth tracking)
        self._diff_scratch: Optional[np.ndarray] = None  # native diff indices
        self._dirty_scratch: Optional[np.ndarray] = None  # fused diff bitmap
        # Retired delta-path mirrors, reusable as pack buffers (full-upload
        # buffers escape to device_put and never come back — lazy host
        # reads). Submit-thread-only.
        self._pack_pool: list[np.ndarray] = []
        self._mirror_recyclable = False
        self._debug = False
        self._grayscale = True
        self._dispatch_flags: tuple = (True, True, True, None, None, "gray", None, None)
        self._host: Optional[dict] = None  # parsed hostpack sections
        self._scalespack_host: Optional[np.ndarray] = None
        # Cross-frame adaptation state + display caches: one shared object so
        # consume views (shallow copies, see snapshot_job) adapt the ladders
        # the next submit reads. The historical flat-attribute names remain
        # as delegating properties below the method definitions.
        self._adapt = _AdaptState()
        self.stats = {
            "lsd_window_misses": 0,
            "lsd_sparse_misses": 0,
            "scalespack_fetches": 0,
            "scales_band_misses": 0,
            "frames": 0,
            "delta_frames": 0,
            "full_uploads": 0,
            "h2d_bytes": 0,
            "device_scales_frames": 0,
            "device_scales_fallbacks": 0,
        }
        # Delta H2D transport chain (SMH_DELTA: auto|0|1; 1 forces it even
        # for tiny frames — used by tests):
        #   _resident      device flat ROI buffer matching the LAST DISPATCH
        #   _mirror        host copy of _resident's contents (diff base)
        #   _pending       what dispatch() must upload-apply for this frame
        #   _pending_host  host packed buffer of the loaded frame
        self.delta_mode = os.environ.get("SMH_DELTA", "auto")
        self._resident: Optional[jax.Array] = None
        self._mirror: Optional[np.ndarray] = None
        self._pending: Optional[tuple] = None
        self._pending_host: Optional[np.ndarray] = None
        # The driver disables this when a heightmap supplies distances or no
        # OCR engine exists: the OCR image then never leaves the device.
        self.scales_enabled = True
        # Engines that only threshold the OCR image (binary_ok) receive it as
        # a bit-packed text mask: 8x less D2H, exact (ops/pipeline.py).
        self.scales_binary_ok = False
        # Engines whose results derive from the image also allow the row-band
        # transport (ship only the text neighbourhood + bar-scan budget).
        self.scales_image_derived = False
        # Engines that read thresholded digits+'m' (smhocr semantics) can be
        # replaced wholesale by the on-device reader: the fused pass segments
        # glyphs, classifies them against the same templates (one matmul) and
        # runs the bar scan, shipping ~1.2 KB of records instead of images
        # (ops/scales_device.py). Capacity overflow falls back to the
        # scalespack + host engine for that frame.
        self.scales_device_ok = False
        # Minimap quiet mask cadence: the driver may skip it on frames where
        # it reuses cached minimap bounds (bounds only move on zoom changes).
        self.quiet_enabled = True
        if lsd_engine == "auto":
            from .. import native

            lsd_engine = "native" if native.available() else "tpu"
        self.lsd_engine = lsd_engine

    # Shared adaptation/caches under the historical flat names: delegating
    # to self._adapt keeps the documented knob surface (tests, ops/warmup)
    # while snapshot_job's shallow copies share one adaptation state.
    _ui_check = _shared_field("ui_check")
    _ui_map_cache = _shared_field("ui_map_cache")
    _ladder_h = _shared_field("ladder_h")
    _ladder_w = _shared_field("ladder_w")
    _rung_h = _shared_field("rung_h")
    _rung_w = _shared_field("rung_w")
    _shrink_streak = _shared_field("shrink_streak")
    _sp_rung = _shared_field("sp_rung")
    _sp_streak = _shared_field("sp_streak")
    _sp_miss_streak = _shared_field("sp_miss_streak")
    _sp_probation = _shared_field("sp_probation")
    _scales_inline = _shared_field("scales_inline")
    _scales_last_check = _shared_field("scales_last_check")
    _scales_stable = _shared_field("scales_stable")
    _band_rung = _shared_field("band_rung")
    _band_streak = _shared_field("band_streak")
    _band_probation = _shared_field("band_probation")

    def set_debug(self, enabled: bool) -> None:
        """When enabled, the fused pass also materializes the intermediate
        images served by get_debug_view (costs extra D2H bandwidth)."""
        self._debug = enabled

    # -- lifecycle -----------------------------------------------------------

    def thread_ctx(self) -> None:
        """No-op: JAX owns device contexts (the reference needed per-thread
        CUDA context binding, vision-gpu/src/cuda.rs:5-13)."""

    def _delta_active(self, total_bytes: int) -> bool:
        if self.delta_mode in ("0", "off"):
            return False
        if self.delta_mode in ("1", "on"):
            return True
        return total_bytes >= _DELTA_MIN_BYTES

    def load_frame(self, frame_bgra: np.ndarray) -> None:
        assert frame_bgra.dtype == np.uint8 and frame_bgra.shape[2] == 4
        h, w = frame_bgra.shape[:2]
        if self.geom is None or (self.geom.frame_w, self.geom.frame_h) != (w, h):
            self.geom = C.map_geometry(w, h)
            self._ladder_h = None
            self._ladder_w = None
            self._resident = None  # resolution change: restart the chain
            self._mirror = None
            self._pack_pool.clear()
            self._mirror_recyclable = False
        g = self.geom
        self.frame_np = frame_bgra
        # Upload only the ROIs the pipeline reads (map + close-button), as
        # ONE flat buffer: ~2.3x less H2D than the whole frame, and a single
        # latency-bound transfer instead of two. The ROI copy goes through
        # shaped assignment — assigning a strided view via reshape(-1) hits a
        # ~100 MB/s numpy slow path (~130 ms at 4K); the shaped copy is
        # row-wise memcpy. The buffer must be FRESH per frame: device_put may
        # read the host memory lazily (it keeps a reference), so reusing a
        # staging buffer tears pipelined frames (two uploads in flight see
        # each other's pixels — caught by test_pipelined_matches_sync).
        map_roi = frame_bgra[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
        btn_roi = frame_bgra[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
        from .. import native

        used = (g.map_h * g.map_w + g.btn_h * g.btn_w) * 3
        total = ((used + _DELTA_CHUNK - 1) // _DELTA_CHUNK) * _DELTA_CHUNK
        fused = (
            native.available()
            and os.environ.get("SMH_NATIVE_PACK", "1") != "0"
            and frame_bgra.strides[2] == 1
            and frame_bgra.strides[1] == 4
        )
        delta_eligible = (
            self._delta_active(total)
            and self._mirror is not None
            and self._mirror.size == total
            and self._resident is not None
        )
        if fused and delta_eligible and os.environ.get("SMH_NATIVE_DIFF", "1") == "0":
            # Debug escape hatch: the fused sweep always diffs natively, so
            # forcing the numpy two-level refine requires dropping to the
            # two-pass path for this frame (pack via cv2, then the refine
            # below). Keeps SMH_NATIVE_DIFF=0 meaningful with the fused
            # pack active (advisor r4).
            fused = False

        # Delta H2D: diff against the HOST MIRROR of the device-resident
        # buffer (not simply the previous frame — a loaded-but-never-
        # dispatched frame must not poison the chain base) and ship only the
        # changed chunks.
        delta = None
        if fused:
            # Fused native planarize+diff: ONE sweep writes the packed
            # layout while the bytes are compared in registers — the packed
            # buffer is never re-read from DRAM (4K: 1.7 ms vs 2.7 for
            # cv2.split + diff_subchunks; identical bytes and index set).
            # In-place ROLLING pack+diff when the mirror is a private host
            # buffer (_mirror_recyclable: it never rode a full upload's
            # lazy device_put read) and the previous load WAS dispatched —
            # an undispatched IN-PLACE load already rolled the mirror
            # forward, desyncing it from the device resident, so that rare
            # case reseeds the chain via a full upload. The mirror becomes
            # this frame's packed buffer directly: no separate mirror
            # read, no write pass (unchanged windows are compared in
            # registers and never stored) — ~46.8 -> ~25 MB of DRAM
            # traffic per 4K frame.
            inplace = delta_eligible and self._mirror_recyclable
            if inplace and self._pending is not None and (
                self._pending_host is self._mirror
            ):
                inplace = False
                delta_eligible = False  # poisoned chain base: reseed
            if inplace:
                packed = self._mirror
            else:
                recycled = self._pack_pool.pop() if self._pack_pool else None
                packed = (
                    recycled
                    if recycled is not None and recycled.size == total
                    else np.empty(total, dtype=np.uint8)
                )
            if delta_eligible:
                n_sub = total // _DELTA_SUB
                scratch = self._diff_scratch
                if scratch is None or scratch.size < n_sub:
                    scratch = self._diff_scratch = np.empty(n_sub, np.int32)
                dirty = self._dirty_scratch
                if dirty is None or dirty.size < n_sub:
                    dirty = self._dirty_scratch = np.empty(n_sub, np.uint8)
                if inplace:
                    n = native.pack_diff_roll(
                        map_roi, btn_roi, packed, dirty, scratch
                    )
                else:
                    n = native.pack_diff(
                        map_roi, btn_roi, packed, self._mirror, dirty, scratch
                    )
                if n == 0:
                    scratch[0] = 0  # flags may still differ: no-op chunk 0
                    n = 1
                bucket = _delta_bucket(n, n_sub)
                if bucket is not None:
                    buf = np.empty(4 * bucket + bucket * _DELTA_SUB, dtype=np.uint8)
                    native.gather_subchunks(packed, scratch, n, bucket, buf)
                    delta = (buf, bucket, buf.size)
            else:
                native.pack_diff(map_roi, btn_roi, packed, None, None, None)
        else:
            packed = _pack_rois_bgr(
                map_roi, btn_roi, pad_to=_DELTA_CHUNK,
                out=self._pack_pool.pop() if self._pack_pool else None,
            )
        if not fused and delta_eligible:
            n_chunks = packed.size // _DELTA_CHUNK
            n_sub = n_chunks * (_DELTA_CHUNK // _DELTA_SUB)
            if native.available() and os.environ.get("SMH_NATIVE_DIFF", "1") != "0":
                # Native diff: identical output to the two-level numpy
                # refine, at memory speed (the numpy != materializes an
                # n_sub*4 bool temp and re-reads it: ~10.7 ms at 4K vs
                # ~1-2 ms here).
                scratch = self._diff_scratch
                if scratch is None or scratch.size < n_sub:
                    scratch = self._diff_scratch = np.empty(n_sub, np.int32)
                n = native.diff_subchunks(packed, self._mirror, scratch)
                if n == 0:
                    scratch[0] = 0  # flags may still differ: no-op chunk 0
                    n = 1
                bucket = _delta_bucket(n, n_sub)
                if bucket is not None:
                    buf = np.empty(4 * bucket + bucket * _DELTA_SUB, dtype=np.uint8)
                    native.gather_subchunks(packed, scratch, n, bucket, buf)
                    delta = (buf, bucket, buf.size)
            else:
                ne = (
                    packed.view(np.uint64).reshape(n_chunks, -1)
                    != self._mirror.view(np.uint64).reshape(n_chunks, -1)
                )
                changed = np.flatnonzero(ne.any(axis=1)).astype(np.int32)
                changed32 = _refine_subchunks(ne, changed)
                bucket = _delta_bucket(int(changed32.size), n_sub)
                if bucket is not None:
                    idx = np.empty(bucket, dtype=np.int32)
                    idx[: changed32.size] = changed32
                    idx[changed32.size :] = changed32[-1]  # repeat: no-op
                    buf = np.empty(4 * bucket + bucket * _DELTA_SUB, dtype=np.uint8)
                    buf[: 4 * bucket].view(np.int32)[:] = idx
                    chunks2d = packed.reshape(n_sub, _DELTA_SUB)
                    data = buf[4 * bucket :].reshape(bucket, _DELTA_SUB)
                    data[: changed32.size] = chunks2d[changed32]
                    data[changed32.size :] = chunks2d[changed32[-1]]
                    delta = (buf, bucket, buf.size)

        # The pending buffers stay HOST-side: dispatch passes them to the jit
        # directly and the transfer rides the call. Buffers are fresh per
        # frame, so a lazy host read cannot tear pipelined frames.
        if delta is not None:
            self._pending = ("delta", *delta)
        else:
            self._pending = ("full", packed, packed.size)
        self._pending_host = packed
        self._results = None
        self._host = None
        self._scalespack_host = None
        self._lsd_crop_host = None

    def get_cpu_frame(self) -> np.ndarray:
        assert self.frame_np is not None
        return self.frame_np

    # -- window ladder ---------------------------------------------------------

    def _crop_size(self) -> tuple[Optional[int], Optional[int]]:
        """The static LSD window for the next dispatch (None, None = full)."""
        g = self.geom
        mask_bytes = g.map_h * ((g.map_w + 7) // 8)
        if mask_bytes <= _MIN_WINDOWED_MASK_BYTES:
            return None, None
        if self._ladder_h is None:
            self._ladder_h = _dim_ladder(g.map_h)
            self._ladder_w = _dim_ladder(g.map_w)
            self._rung_h = min(self._rung_h, len(self._ladder_h) - 1)
            self._rung_w = min(self._rung_w, len(self._ladder_w) - 1)
        ch = self._ladder_h[self._rung_h]
        cw = self._ladder_w[self._rung_w]
        if (ch, cw) == (g.map_h, g.map_w):
            return None, None
        return ch, cw

    def _sparse_budget(self) -> Optional[int]:
        """Word budget for THIS dispatch, or None when the transport is off
        (env opt-out, tiny maps where windowing is also off, dense-content
        sessions that repeatedly overflow the largest useful rung). When it
        returns a budget, dispatch() drops the window crop entirely
        (crop_h = crop_w = None): the pack's sparse sections reconstruct the
        full plane.

        NOT a pure query: it steps the probation counter and clamps the
        rung to the geometry, so it must be called exactly ONCE per dispatch
        (the _scales_band_size lesson — a second caller would corrupt the
        hysteresis). Debug/logging should read _sp_rung directly."""
        if not _sparse_mode():
            return None
        g = self.geom
        mask_bytes = g.map_h * ((g.map_w + 7) // 8)
        if mask_bytes <= _MIN_WINDOWED_MASK_BYTES:
            return None
        if self._sp_probation > 0:  # stepped aside: re-probe periodically
            self._sp_probation += 1
            if self._sp_probation <= _SHRINK_AFTER:
                return None
            self._sp_probation = 0
            self._sp_miss_streak = 0
        # Largest rung that still undercuts shipping the full plane: at
        # 8 bytes/word the sparse sections reach mask_bytes at budget
        # mask_bytes/8; beyond ~half of that, sparse stops paying.
        self._sp_rung = min(self._sp_rung, len(_SPARSE_BUDGETS) - 1)
        budget = _SPARSE_BUDGETS[self._sp_rung]
        while budget * 8 >= mask_bytes and self._sp_rung > 0:
            self._sp_rung -= 1
            budget = _SPARSE_BUDGETS[self._sp_rung]
        if budget * 8 >= mask_bytes:
            return None
        return budget

    def _adapt_sp_rung(self, nz: int, budget: int) -> None:
        """Escalate PROACTIVELY when the word count nears the budget (the
        5/4 slack, so a growing marker drag steps up before it overflows —
        the window ladder's behaviour), escalate on an actual miss, shrink
        after a sustained streak. The rung is always clamped to the ladder:
        repeated top-rung misses used to push it past the end, and a later
        resolution change then indexed _SPARSE_BUDGETS out of range."""
        top = len(_SPARSE_BUDGETS) - 1
        need = nz * _SP_SLACK_NUM // _SP_SLACK_DEN
        want = 0
        for i, b in enumerate(_SPARSE_BUDGETS):
            want = i
            if b >= need:
                break
        if nz > budget:
            self._sp_miss_streak += 1
            self._sp_rung = min(max(self._sp_rung + 1, want), top)
            self._sp_streak = 0
            if self._sp_miss_streak >= _SP_OFF_AFTER:
                # Dense content: the mask has outgrown what sparse can carry
                # cheaply. Step aside (window ladder takes over) and re-probe
                # after a while — one pathological scene must not disable the
                # transport for the whole session.
                self._sp_probation = 1
            return
        self._sp_miss_streak = 0
        if want > self._sp_rung:
            # Fits today but within the slack of overflowing: step up NOW so
            # the next frame's growth does not cost a full-mask fallback.
            # PROACTIVE escalation is capped at the warmed neighbourhood
            # (ops/warmup compiles DEFAULT-1..DEFAULT+2): a moderately dense
            # scene must not jit an unwarmed rung mid-session on a guess —
            # past the cap, only an actual miss (whose fallback fetch is
            # exact anyway) compiles higher rungs.
            self._sp_rung = min(want, top, max(self._sp_rung, _SP_WARM_MAX))
            self._sp_streak = 0
        elif want < self._sp_rung:
            self._sp_streak += 1
            if self._sp_streak >= _SHRINK_AFTER:
                self._sp_rung -= 1
                self._sp_streak = 0
        else:
            self._sp_streak = 0

    def _scales_band_size(self) -> tuple[Optional[int], bool]:
        """Pure query: (static OCR row-band height for the next dispatch or
        None for full, ladder_maxed). No state is mutated here — the
        probation ladder step happens once per dispatch in
        _step_band_probation (a second caller — debug, logging, a batch
        path — must not advance the hysteresis)."""
        if not self.scales_image_derived:
            return None, False  # canned engines: bboxes may point anywhere
        if self._debug:
            return None, False  # debug views want the true full-height binarize
        g = self.geom
        brq_bits = g.brq_h * ((g.brq_w + 7) // 8)
        if brq_bits <= 4 * 1024:  # tiny test frames: banding can't pay
            return None, False
        ladder = _dim_ladder(g.brq_h)
        band = ladder[min(self._band_rung, len(ladder) - 1)]
        if band >= g.brq_h:
            return None, True
        return band, False

    def _step_band_probation(self, maxed: bool) -> None:
        """Dispatch-time ladder bookkeeping: while the ladder is maxed out,
        periodically re-probe a smaller band so one pathological frame can't
        disable banding for the whole session."""
        if not maxed:
            self._band_probation = 0
            return
        self._band_probation += 1
        if self._band_probation >= _SHRINK_AFTER:
            self._band_probation = 0
            self._band_rung = len(_dim_ladder(self.geom.brq_h)) - 2

    @staticmethod
    def _rung_for(ladder: list[int], need: int) -> int:
        for i, d in enumerate(ladder):
            if d >= need:
                return i
        return len(ladder) - 1

    def _adapt_rung(self, bh: int, bw: int) -> None:
        """Escalate immediately, shrink after a sustained streak; height and
        width adapt independently (one shared streak counter keeps the
        hysteresis simple)."""
        if self._ladder_h is None:
            return
        pad = 2 * ops_pipeline.LSD_CROP_MARGIN + _RUNG_SLACK
        want_h = self._rung_for(self._ladder_h, bh + pad)
        want_w = self._rung_for(self._ladder_w, bw + pad)
        if want_h > self._rung_h or want_w > self._rung_w:
            self._rung_h = max(self._rung_h, want_h)
            self._rung_w = max(self._rung_w, want_w)
            self._shrink_streak = 0
        elif want_h < self._rung_h or want_w < self._rung_w:
            self._shrink_streak += 1
            if self._shrink_streak >= _SHRINK_AFTER:
                if want_h < self._rung_h:
                    self._rung_h -= 1
                if want_w < self._rung_w:
                    self._rung_w -= 1
                self._shrink_streak = 0
        else:
            self._shrink_streak = 0

    # -- stages ---------------------------------------------------------------

    def dispatch(self, grayscale: Optional[bool] = None) -> None:
        """Launch the fused pass for the loaded frame (async: returns before
        the device finishes; the hostpack fetch in crop_to_map blocks).
        Separated from crop_to_map so a pipelined loop can overlap frame
        N+1's upload+dispatch with frame N's fetch + host stages."""
        assert (self.rois_dev is not None or self._pending is not None) and self.geom is not None
        if grayscale is not None:
            self._grayscale = grayscale
        g = self.geom
        sparse = self._sparse_budget()
        if sparse is not None:
            crop_h = crop_w = None  # sparse sections reconstruct the plane
        else:
            crop_h, crop_w = self._crop_size()
        if not self.scales_enabled:
            inline = "none"
        elif self.scales_device_ok:
            inline = "device"  # records are ~1.2 KB: always inline, no band
        elif not self._scales_inline:
            inline = "none"
        elif self.scales_binary_ok:
            inline = "binary"
        else:
            inline = "gray"
        band = None
        if inline in ("binary", "gray"):
            band, maxed = self._scales_band_size()
            self._step_band_probation(maxed)
        self._dispatch_flags = (
            self.scales_enabled,
            self.quiet_enabled,
            self._grayscale,
            crop_h,
            crop_w,
            inline,
            band,
            sparse,
        )
        kw = dict(
            map_h=g.map_h,
            map_w=g.map_w,
            btn_h=g.btn_h,
            btn_w=g.btn_w,
            grayscale=self._grayscale,
            with_ocr=self.scales_enabled,
            with_quiet=self.quiet_enabled,
            crop_h=crop_h,
            crop_w=crop_w,
            scales_inline=inline,
            with_mask_output=(self.lsd_engine != "native") or self._debug,
            channels=ROI_CHANNELS,
            scales_band=band,
            sparse_budget=sparse,
        )
        pending, self._pending = self._pending, None
        if pending is not None and pending[0] == "delta":
            _, buf_np, bucket, nbytes = pending
            # Chain-depth bound (the per-frame twin of BatchPipeline.submit's
            # barrier): never hold a deep chain of dispatches whose
            # residents are all unmaterialized. Shallow chains (depth <= 3:
            # the pipelined loop's steady state) MUST NOT barrier here:
            # waiting for completion on every frame would serialize the
            # pipeline on exactly the latency the async transport hides.
            a = self._adapt
            if self._resident is not None and a.disp_seq - a.mat_seq >= 3:
                wait_ready(self._resident)
                a.mat_seq = max(a.mat_seq, a.disp_seq)
            out = ops_pipeline._analyze_delta_flat(
                self._resident, buf_np, bucket=bucket, chunk=_DELTA_SUB, **kw
            )
            self._resident = out.pop("resident")
            self.rois_dev = self._resident
            self._results = out
            self._retire_mirror(recyclable_next=True)
            self.stats["delta_frames"] += 1
            self.stats["h2d_bytes"] += nbytes
        elif pending is not None:
            # Full upload: the jit echoes the uploaded buffer back as a
            # device output, which seeds the delta chain for the next frame.
            _, packed_np, nbytes = pending
            out = ops_pipeline._analyze_packed_flat(
                packed_np, with_resident=True, **kw
            )
            self._resident = out.pop("resident")
            self.rois_dev = self._resident
            self._results = out
            # This frame's packed buffer rode device_put: it escaped.
            self._retire_mirror(recyclable_next=False)
            self.stats["full_uploads"] += 1
            self.stats["h2d_bytes"] += nbytes
        else:
            # No pending (re-dispatch with new flags): analyze the resident.
            self._results = ops_pipeline._analyze_packed_flat(self.rois_dev, **kw)

        # Start the hostpack D2H NOW: it completes in the background while
        # the host packs/diffs the next frame or scans the previous one, so
        # the consume-side np.asarray finds the bytes already local
        # (pipelined/batched modes) or waits only the true completion time
        # (sync mode). See start_fetch.
        start_fetch(self._results["hostpack"])
        self._adapt.disp_seq += 1
        self._job_seq = self._adapt.disp_seq


    def _retire_mirror(self, recyclable_next: bool) -> None:
        """Advance the diff base to the just-dispatched frame's pack buffer.
        The OLD mirror goes back to the pack pool iff its own dispatch rode
        the delta path (a fully-uploaded buffer is lazily read by the
        device and must never be rewritten). In-place rolling frames pack
        INTO the mirror (old is the new pending_host) — nothing retires."""
        old = self._mirror
        if (
            old is not None
            and old is not self._pending_host
            and self._mirror_recyclable
            and len(self._pack_pool) < 2
        ):
            self._pack_pool.append(old)
        self._mirror = self._pending_host
        self._mirror_recyclable = recyclable_next

    def snapshot_job(self) -> "TpuBackend":
        """Capture the in-flight frame as a CONSUME VIEW: a shallow copy of
        the backend whose per-frame fields (results, geom, dispatch flags,
        parsed host sections) are frozen to this frame, while the adaptation
        state (_AdaptState), stats dict and delta chain stay shared by
        reference. The view exposes the full consume surface (crop_to_map,
        the marker/scales branches, debug views), so the driver can process
        frame N on it WHILE load_frame/dispatch for frame N+1 mutate the
        real backend — from another thread: submit writes only per-frame
        fields of the real backend plus the (submit-owned) delta chain;
        consume writes only per-frame fields of the view plus the shared
        adaptation ints, which are GIL-atomic."""
        import copy

        view = copy.copy(self)
        # The view must never re-enter the submit half: the delta chain is
        # owned by the real backend (a stale _pending on the view would
        # re-dispatch frame N's upload).
        view._pending = None
        view._pending_host = None
        # Reset consume-side parse caches (the copy inherits whatever the
        # live frame had; the view parses its own hostpack lazily).
        view._host = None
        view._scalespack_host = None
        view._lsd_crop_host = None
        return view

    def crop_to_map(self, grayscale: bool) -> Optional[tuple]:
        assert (self.rois_dev is not None or self._pending is not None) and self.geom is not None
        g = self.geom

        # ONE dispatch, ONE device->host fetch: the packed buffer carries the
        # red gate, checksums, LSD bbox + mask words and the minimap rect.
        # (The reference's "gate first, then compute" order inverts: the
        # sleeping frame's compute rides the same dispatch instead of a
        # separate gate roundtrip.)
        if self._results is None or self._grayscale != grayscale:
            self._grayscale = grayscale
            self.dispatch()
        with_ocr, with_quiet, _, crop_h, crop_w, inline, band, sparse = self._dispatch_flags
        pack = np.asarray(self._results["hostpack"])
        # This program's outputs are materialized (fetch done) — the delta
        # chain's depth bound can advance past it.
        seq = getattr(self, "_job_seq", 0)
        if seq > self._adapt.mat_seq:
            self._adapt.mat_seq = seq
        layout = ops_pipeline.hostpack_layout(
            g.map_h, g.map_w, with_ocr=with_ocr, with_quiet=with_quiet,
            crop_h=crop_h, crop_w=crop_w, scales_inline=inline, scales_band=band,
            sparse_budget=sparse,
        )
        eff_ch = g.map_h if crop_h is None else crop_h
        eff_cw = g.map_w if crop_w is None else crop_w

        def sect(name):
            off, size = layout[name]
            return pack[off : off + size]

        red_ratio = float(sect("red_ratio").view(np.float32)[0])
        if red_ratio < C.CLOSE_DEPLOYMENT_BUTTON_RED_PIXEL_THRESHOLD:
            return None

        self.stats["frames"] += 1
        mask_row = (g.map_w + 7) // 8
        y0, y1, x0, x1, cy0, cx0 = (int(v) for v in sect("lsd_meta").view(np.int32))
        self._host = {
            "ui_check": tuple(int(v) for v in sect("ui_check").view(np.uint32)),
            "lsd_bbox": (y0, y1, x0, x1),
        }
        if with_ocr:
            check = tuple(int(v) for v in sect("scales_check").view(np.uint32))
            self._host["scales_check"] = check
            brq_row = (g.brq_w + 7) // 8
            if inline == "device":
                self._host["scales_records"] = ops_scales_device.decode_records(
                    sect("scales_rec").view(np.int16)
                )
            if inline in ("binary", "gray"):
                # Band transport state for the scales consumers:
                #   None                  -> sections are full-height images
                #   (band, b0, textless)  -> sections are a row band at b0
                #   "miss"                -> band too small; use scalespack
                self._host["scales_band"] = None
                rows = g.brq_h
                parse = True
                if band is not None:
                    rows = band
                    oy0, oy1, b0 = (int(v) for v in sect("scales_meta").view(np.int32))
                    if oy0 >= oy1:  # no text pixels: empty canvases are exact
                        self._host["scales_band"] = (band, 0, True)
                        parse = False
                    else:
                        budget = ops_pipeline.scales_scan_budget(g.brq_w)
                        need_end = min(oy1 + budget, g.brq_h)
                        if b0 + band >= need_end:
                            self._host["scales_band"] = (band, b0, False)
                            # shrink hysteresis: sustained small text bands
                            want = self._rung_for(_dim_ladder(g.brq_h), need_end - oy0)
                            if want < self._band_rung:
                                self._band_streak += 1
                                if self._band_streak >= _BAND_SHRINK_AFTER:
                                    self._band_rung -= 1
                                    self._band_streak = 0
                            else:
                                self._band_streak = 0
                        else:
                            # text rows outgrew the band: fall back to the
                            # device-resident full images and escalate
                            # straight to the rung that would have fit.
                            self.stats["scales_band_misses"] += 1
                            want = self._rung_for(_dim_ladder(g.brq_h), need_end - oy0)
                            self._band_rung = max(self._band_rung + 1, want)
                            self._band_streak = 0
                            self._host["scales_band"] = "miss"
                            parse = False
                if parse:
                    self._host["scales_bits_inline"] = sect("scales_bits").reshape(rows, brq_row)
                    if inline == "binary":
                        self._host["ocr_bits_inline"] = sect("ocr_bits").reshape(rows, brq_row)
                    else:
                        self._host["ocr_img_inline"] = sect("ocr_img").reshape(rows, g.brq_w)
            # Transport adaptation: unchanged checksums (static map) drop the
            # inline images from future packs; any change flips them back in.
            if check == self._scales_last_check:
                self._scales_stable += 1
                if self._scales_stable >= _INLINE_STABLE_AFTER:
                    self._scales_inline = False
            else:
                self._scales_last_check = check
                self._scales_stable = 0
                self._scales_inline = True
        if with_quiet:
            self._host["minimap_rect"] = tuple(int(v) for v in sect("minimap_rect").view(np.int32))

        empty = y0 >= y1 or x0 >= x1
        if empty:
            self._host["lsd_crop_bits"] = None
            self._host["lsd_offset"] = (0, 0)
            self._host["lsd_crop_shape"] = (0, 0)
            self._march_max_len = 0.0
            if sparse is not None:
                self._adapt_sp_rung(int(sect("lsd_nz").view(np.int32)[0]), sparse)
            elif self._ladder_h is not None:
                self._adapt_rung(0, 0)
        elif sparse is not None:
            self._march_max_len = math.hypot(y1 - y0, x1 - x0) + 1.0
            nz = int(sect("lsd_nz").view(np.int32)[0])
            if nz <= sparse:
                # Exact reconstruction of the full bit plane from the
                # compacted words (~600 words / 5 KB for a real 4K mask).
                self._host["lsd_crop_bits"] = ops_pipeline.sparse_mask_host(
                    nz,
                    sect("lsd_sp_idx").view(np.int32),
                    sect("lsd_sp_dat").view(np.uint32),
                    g.map_h,
                    g.map_w,
                )
            else:
                # Sparse miss: the words past the budget were dropped — fall
                # back to the device-resident full mask (one extra fetch).
                self.stats["lsd_sparse_misses"] += 1
                self._host["lsd_crop_bits"] = np.asarray(self._results["lsd_bits"])
            self._host["lsd_offset"] = (0, 0)
            self._host["lsd_crop_shape"] = (g.map_h, g.map_w)
            self._adapt_sp_rung(nz, sparse)
        else:
            m = ops_pipeline.LSD_CROP_MARGIN
            fit = (
                cy0 + eff_ch >= min(y1 + m, g.map_h)
                and cx0 + eff_cw >= min(x1 + m, g.map_w)
            )
            self._march_max_len = math.hypot(y1 - y0, x1 - x0) + 1.0
            if fit:
                crow = (eff_cw + 7) // 8
                self._host["lsd_crop_bits"] = sect("lsd_crop").reshape(eff_ch, crow)
                self._host["lsd_offset"] = (cx0, cy0)
                self._host["lsd_crop_shape"] = (eff_ch, eff_cw)
            else:
                # Window miss: fall back to the device-resident full mask
                # (one extra fetch this frame) and escalate the rung.
                self.stats["lsd_window_misses"] += 1
                self._host["lsd_crop_bits"] = np.asarray(self._results["lsd_bits"])
                self._host["lsd_offset"] = (0, 0)
                self._host["lsd_crop_shape"] = (g.map_h, g.map_w)
            if self._ladder_h is not None:
                self._adapt_rung(y1 - y0, x1 - x0)

        if self._debug:
            # Debug views want the extra intermediates: run the full-output
            # pass too (debug mode trades speed for visibility).
            map_dev = self.rois_dev[: g.map_h * g.map_w * ROI_CHANNELS].reshape(
                ROI_CHANNELS, g.map_h, g.map_w
            )
            self._results.update(
                ops_pipeline.analyze_map_planar(
                    map_dev, grayscale=grayscale, with_isolated=True
                )
            )

        # The ui map is display-only — it is NOT on the frame->markers+scales
        # critical path. crop_to_map therefore returns a lazy fetcher: the UI /
        # web layer materializes it when it actually wants pixels, and an
        # unchanged device-side checksum reuses the previous host copy
        # (the reference skips texture uploads with a host crc32 the same
        # way, src/ui/map.rs:222-233).
        results = self._results
        ui_check_host = self._host["ui_check"]

        def fetch_ui_map() -> np.ndarray:
            check = (*ui_check_host, grayscale)
            if (
                self._ui_map_cache is not None
                and check == self._ui_check
                and self._ui_map_cache.shape[:2] == (g.map_h, g.map_w)
            ):
                return self._ui_map_cache
            ui = np.asarray(results["ui"])
            ui_map = np.empty((g.map_h, g.map_w, 4), dtype=np.uint8)
            if ui.ndim == 2:
                ui_map[..., 0] = ui_map[..., 1] = ui_map[..., 2] = ui
            else:
                ui_map[..., :3] = ui
            ui_map[..., 3] = 255
            self._ui_check = check
            self._ui_map_cache = ui_map
            return ui_map

        return fetch_ui_map, (g.map_x, g.map_y, g.map_w, g.map_h)

    def minimap_rect(self):
        """Minimap bounds computed ON DEVICE in the fused pass (16 bytes in
        the hostpack; the reference re-walks the CPU frame every frame,
        src/vision/find_minimap.rs:48-146). Returns a Rect, or None when the
        dispatch skipped it (quiet_enabled=False / map too small)."""
        from ..geometry import Rect

        if self._host is None or self.geom is None or "minimap_rect" not in self._host:
            return None
        if self.geom.map_w < 3 or self.geom.map_h < 3:
            return None
        l, t, r, b = self._host["minimap_rect"]
        return Rect(left=l, top=t, right=r, bottom=b)

    # -- scales branch (lazy, checksum-gated) ----------------------------------

    def scales_check(self) -> Optional[tuple]:
        """Device-computed content checksum of (scales binarize, OCR image).
        The driver's ratio cache keys on this WITHOUT fetching any pixels."""
        if self._host is None:
            return None
        return self._host.get("scales_check")

    def scales_fingerprint(self) -> Optional[int]:
        """Back-compat fingerprint for drivers keying their own cache."""
        check = self.scales_check()
        if check is None:
            return None
        return hash(check) & 0xFFFFFFFF

    def device_scales(self):
        """(ocr_results, ratio) read entirely ON DEVICE this frame, or None
        when the dispatch didn't pack records / they lost structure with no
        trusted read (caller then takes the image path). ratio=None with a
        non-None return means a clean 'no scales on screen' — the caller
        must NOT fall back (that's the zero-byte steady state)."""
        host = self._host or {}
        dev = host.get("scales_records")
        if dev is None:
            return None
        ratio = ops_scales_device.ratio_from_records(dev)
        if ratio is not None:
            self.stats["device_scales_frames"] += 1
            return dev.words, ratio
        if dev.complete:
            self.stats["device_scales_frames"] += 1
            return dev.words, None
        self.stats["device_scales_fallbacks"] += 1
        return None

    def _fetch_scalespack(self) -> np.ndarray:
        if self._scalespack_host is None:
            assert self._results is not None and "scalespack" in self._results, (
                "scales branch consumed but dispatch packed no scales transport"
            )
            self._scalespack_host = np.asarray(self._results["scalespack"])
            self.stats["scalespack_fetches"] += 1
        return self._scalespack_host

    def ocr_preprocess(self) -> np.ndarray:
        assert self.geom is not None
        g = self.geom
        img = _ocr_image_from_host(self._host or {}, g)
        if img is not None:
            return img
        layout = ops_pipeline.scalespack_layout(g.map_h, g.map_w)
        off, size = layout["ocr_img"]
        return self._fetch_scalespack()[off : off + size].reshape(g.brq_h, g.brq_w)

    def find_scales_preprocess(self, scales_start_y: int) -> np.ndarray:
        """Returns the binarized BRQ as 0/255 u8 (bit-unpacked)."""
        assert self.geom is not None
        g = self.geom
        img = _scales_image_from_host(self._host or {}, g)
        if img is not None:
            return img
        layout = ops_pipeline.scalespack_layout(g.map_h, g.map_w)
        off, size = layout["scales_bits"]
        bits = self._fetch_scalespack()[off : off + size].reshape(g.brq_h, (g.brq_w + 7) // 8)
        return ops_pipeline.unpack_bits_host(bits, g.brq_w) * np.uint8(255)

    def snapshot_scales_job(self) -> Optional[dict]:
        """Self-contained handle for an async scales branch: checksum + a
        fetch closure over THIS frame's host sections / device arrays (both
        immutable snapshots), safe to run while later frames dispatch."""
        if self._host is None or "scales_check" not in self._host:
            return None
        g = self.geom
        host = self._host  # captured: adopt_job replaces, never mutates
        stats = self.stats
        layout = ops_pipeline.scalespack_layout(g.map_h, g.map_w)
        # Only pin the device scalespack when a fallback is actually possible
        # (band miss / no inline sections) — capturing the whole results dict
        # would keep every device buffer of this frame alive for the worker.
        band = host.get("scales_band")
        textless = isinstance(band, tuple) and band[2]
        has_inline = "scales_bits_inline" in host and (
            "ocr_bits_inline" in host or "ocr_img_inline" in host
        )
        records = host.get("scales_records")
        records_ratio = (
            ops_scales_device.ratio_from_records(records)
            if records is not None
            else None
        )
        records_serve = records is not None and (
            records.complete or records_ratio is not None
        )
        needs_fallback = band == "miss" or not (
            textless or has_inline or records_serve
        )
        spack_dev = self._results.get("scalespack") if needs_fallback else None

        def fetch() -> tuple[np.ndarray, np.ndarray]:
            ocr_img = _ocr_image_from_host(host, g)
            scales_img = _scales_image_from_host(host, g)
            if ocr_img is None or scales_img is None:
                assert spack_dev is not None, "fallback needed but not captured"
                pack = np.asarray(spack_dev)
                stats["scalespack_fetches"] += 1
                so, ss = layout["scales_bits"]
                oo, os_ = layout["ocr_img"]
                scales_img = ops_pipeline.unpack_bits_host(
                    pack[so : so + ss].reshape(g.brq_h, (g.brq_w + 7) // 8), g.brq_w
                ) * np.uint8(255)
                ocr_img = pack[oo : oo + os_].reshape(g.brq_h, g.brq_w)
            return ocr_img, scales_img

        job = {"check": host["scales_check"], "fetch": fetch}
        if records is not None:
            # Telemetry parity with the sync path (device_scales counts on
            # checksum-cache MISS only): the consumer calls `count` when it
            # actually consumes the job, not on every snapshot.
            job["count"] = lambda key: stats.__setitem__(key, stats[key] + 1)
            job["had_records"] = True
        if records_serve:
            # Fully-device read: the async step consumes it inline (no
            # worker, no fetch) — ratio=None here is a clean "no scales".
            job["device"] = (records.words, records_ratio)
        return job

    # -- markers branch ---------------------------------------------------------

    def isolate_map_markers(self) -> None:
        """Fused into the crop_to_map dispatch."""

    def mask_marker_lines(self) -> None:
        """Fused into the crop_to_map dispatch; unpacks only the mask-bbox
        slice of the windowed crop (exact — see ops_pipeline.bbox_crop_host)."""
        assert self._host is not None and self.geom is not None
        bits = self._host["lsd_crop_bits"]
        if bits is None:  # empty mask: no white pixels anywhere
            self._lsd_crop_host = np.zeros((0, 0), dtype=np.uint8)
            self._lsd_offset = (0, 0)
            return
        self._lsd_crop_host, self._lsd_offset = ops_pipeline.bbox_crop_host(
            bits,
            self._host["lsd_bbox"],
            self._host["lsd_offset"],
            self._host["lsd_crop_shape"],
        )

    def _full_mask_host(self) -> np.ndarray:
        """Full-size 0/255 host mask (debug views, device-march seed scan)."""
        assert self._results is not None and self.geom is not None
        g = self.geom
        bits = np.asarray(self._results["lsd_bits"])
        return ops_pipeline.unpack_bits_host(bits, g.map_w) * np.uint8(255)

    def _lsd_mask_dev(self):
        """Device u8 mask for the ray-march engine. The production dispatch
        (native engine, no debug) drops the mask output to save HBM
        writeback; contract callers get it rebuilt on device from the
        bit-packed plane (one cheap dispatch, cached per frame)."""
        assert self._results is not None and self.geom is not None
        if "lsd_mask" not in self._results:
            self._results["lsd_mask"] = ops_pipeline.unpack_bits_device(
                self._results["lsd_bits"], self.geom.map_w
            )
        return self._results["lsd_mask"]

    def find_longest_line(self, mask: np.ndarray, pt: Point, max_gap: float) -> tuple[Line, float]:
        return ops_lsd.find_longest_line(
            self._lsd_mask_dev(), pt, max_gap, max_len=self._march_max_len
        )

    def _find_longest_lines_batch(self, mask: np.ndarray, pts: list[Point], max_gap: float):
        return ops_lsd.find_longest_lines_batch(
            self._lsd_mask_dev(), pts, max_gap, max_len=self._march_max_len
        )

    def find_marker_lines(self, max_gap: int) -> list[Line]:
        if self._lsd_crop_host is None:
            self.mask_marker_lines()
        crop = self._lsd_crop_host
        if crop.size == 0:
            return []
        ox, oy = self._lsd_offset

        if self.lsd_engine == "native":
            from .. import native

            # Full-plane coordinates through the windowed view: bit-identical
            # to scanning the full mask (outside-window pixels are black by
            # bbox construction).
            g = self.geom
            return native.find_lines(
                crop, max_gap, full_shape=(g.map_h, g.map_w), offset=(ox, oy)
            )
        else:
            # Device march samples the FULL device mask, so seeds must be in
            # map coordinates: paste the crop into a full-size canvas (host
            # memset, ~sub-ms) and scan that.
            g = self.geom
            if crop.shape == (g.map_h, g.map_w):
                canvas = crop
            else:
                canvas = np.zeros((g.map_h, g.map_w), dtype=np.uint8)
                canvas[oy : oy + crop.shape[0], ox : ox + crop.shape[1]] = crop
            return lsd.find_lines(
                canvas,
                max_gap,
                self.find_longest_line,
                find_longest_lines_batch=self._find_longest_lines_batch,
            )

    # -- debug ----------------------------------------------------------------

    def get_debug_view(self, choice: DebugView) -> Optional[np.ndarray]:
        if self._results is None or choice == DebugView.NONE:
            return None

        def gray_rgba(img: np.ndarray) -> np.ndarray:
            out = np.empty((*img.shape, 4), dtype=np.uint8)
            out[..., 0] = out[..., 1] = out[..., 2] = img
            out[..., 3] = 255
            return out

        def rgb_rgba(img: np.ndarray) -> np.ndarray:
            out = np.empty((*img.shape[:2], 4), dtype=np.uint8)
            out[..., :3] = img
            out[..., 3] = 255
            return out

        host = self._host or {}
        scales_avail = (
            "scalespack" in self._results
            or "ocr_img_inline" in host
            or "ocr_bits_inline" in host
        )
        if choice == DebugView.OCR_INPUT:
            if not scales_avail:
                return None
            return gray_rgba(self.ocr_preprocess())
        if choice == DebugView.FIND_SCALES_INPUT:
            if not scales_avail:
                return None
            return gray_rgba(self.find_scales_preprocess(0))
        if choice == DebugView.LSD_INPUT:
            return gray_rgba(self._full_mask_host())
        if choice == DebugView.LSD_PREPROCESS and "isolated_map" in self._results:
            return rgb_rgba(np.asarray(self._results["isolated_map"]))
        if choice == DebugView.CROPPED_BRQ and "cropped_brq" in self._results:
            return rgb_rgba(np.asarray(self._results["cropped_brq"]))
        return None
