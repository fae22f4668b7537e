"""Batched frame pipeline: throughput mode.

Processes B frames per device dispatch with ONE host fetch for the whole
batch — the per-frame dispatch and fetch cost divides by B. This is the BASELINE "streaming capture loop / batched frames" config and
the offline-analysis API (video files, multiple game clients). Detection
semantics are identical to the per-frame driver: the host stages (LSD scan,
minimap walk, scale bars) run per frame on the fetched masks.

v2: the batch hostpack carries the windowed LSD crops (per-frame device
bboxes; frames whose bbox outgrew the window fall back to one batched fetch
of their full bit-masks), the scalespack (OCR image + scales binarize) is
fetched once per batch and only when some frame's device checksum missed the
ratio cache, and the per-frame host stages run on a thread pool (the OCR
engine call itself is serialized — the engine singleton is not re-entrant)."""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import jax
import numpy as np

from .. import consts as C
from ..geometry import Line, Rect
from ..ops import pipeline as ops_pipeline
from . import lsd as vlsd
from . import mpx_ratio as mpx
from .reference import find_longest_line as oracle_march


@dataclasses.dataclass
class BatchResult:
    sleeping: bool
    markers: list[Line]
    minimap_bounds: Optional[Rect]
    meters_to_px_ratio: Optional[float]


class BatchPipeline:
    """Fixed-resolution batched analyzer (one jit bucket per (res, B))."""

    def __init__(
        self,
        frame_w: int,
        frame_h: int,
        batch: int = 8,
        ocr_engine=None,
        lsd_window: Optional[float] = 0.5,
        host_workers: int = 4,
        mesh=None,
    ) -> None:
        """lsd_window: LSD crop window as a fraction of the map (None = full
        mask in the pack; the per-frame driver's adaptive ladder does not
        apply here — batch jobs are offline and retry-free, so a fixed window
        + full-mask fallback keeps one jit bucket).

        mesh: a jax.sharding.Mesh with a "dp" axis — the multi-chip mode.
        The batch axis is laid out over "dp" and XLA SPMD runs the SAME
        compiled per-frame DAG on each chip's slice (the vmap in
        _analyze_batch_packed has no cross-frame dependency, so the only
        collectives are the output gather). The cross-batch delta chain is
        disabled on a mesh: delta reconstruction is a lax.scan over the
        batch axis — a sequential cross-chip dependency that would serialize
        the very parallelism the mesh buys (and batch-DP targets throughput
        over independent clients/backlogs, not single-stream video latency).
        """
        self.geom = C.map_geometry(frame_w, frame_h)
        self.batch = batch
        self.ocr_engine = ocr_engine
        self.mesh = mesh
        if mesh is not None:
            dp = mesh.shape["dp"]
            assert batch % dp == 0, f"batch={batch} not divisible by dp={dp}"
        g = self.geom
        mask_bytes = g.map_h * ((g.map_w + 7) // 8)
        # Sparse mask transport (see tpu_backend._SPARSE_BUDGETS): one fixed
        # word budget for the whole job — batch jobs are offline and
        # retry-free, so a static budget + the per-frame full-mask fallback
        # keeps one jit bucket. 2048 words = 16 KB of pack sections per
        # frame; a real 4K marker mask is ~600 words, so misses are rare and
        # each costs one extra (batched) fetch, not a detection error.
        from .tpu_backend import _MIN_WINDOWED_MASK_BYTES, _sparse_mode

        self.sparse_budget: Optional[int] = None
        if _sparse_mode() and mask_bytes > _MIN_WINDOWED_MASK_BYTES:
            self.sparse_budget = min(2048, mask_bytes // 16)
        if (
            self.sparse_budget is not None
            or lsd_window is None
            or mask_bytes <= _MIN_WINDOWED_MASK_BYTES
        ):
            self.crop_h: Optional[int] = None
            self.crop_w: Optional[int] = None
        else:
            self.crop_h = max(1, int(g.map_h * lsd_window))
            self.crop_w = max(1, int(g.map_w * lsd_window))
        from .. import native

        self._native = native if native.available() else None
        self._diff_scratch = None  # int32 index scratch for the native diff
        self._dirty_scratch = None  # u8 sub-chunk bitmap for the fused diff
        self._pool = ThreadPoolExecutor(max_workers=max(1, host_workers), thread_name_prefix="batch-host")
        self._ocr_lock = threading.Lock()
        self._scales_cache: dict = {}
        # Cross-batch delta chain (same transport as the per-frame backend,
        # scaled to video: frame i diffs against frame i-1, batch 0's head
        # against the previous batch's tail kept device-resident).
        import os as _os

        self.delta_mode = _os.environ.get("SMH_DELTA", "auto")
        self._resident = None  # device flat ROI buffer = last analyzed frame
        self._mirror: Optional[np.ndarray] = None  # host copy of _resident
        # Reusable pack buffer (~80 MB at 4K B=8): a fresh np.empty per
        # batch pays ~10-20 ms of kernel page-zeroing on first touch. Safe
        # to recycle ONLY when the previous batch rode the delta path (the
        # packed rois never reach the device then — only the delta buf and
        # the _mirror copy do); a full upload hands rois to device_put,
        # which reads host memory lazily, so that buffer is dropped.
        self._rois_buf: Optional[np.ndarray] = None
        # Materialization tracking: _fetched_seq = highest submit seq whose
        # hostpack fetch has completed (program done => the chain tail
        # resident is materialized). `_fetched_seq < _seq` means a previous
        # program may still be un-materialized: the delta submit then pays
        # the 1-byte tail poke; when the collector already proved the
        # previous program finished, the barrier is free. (This is the
        # barrier condition itself — NOT an uncollected-count: a count
        # decremented before the fetch completes would open a window where
        # a concurrent submit skips the barrier entirely.)
        self._seq = 0
        self._fetched_seq = 0
        self._fetch_lock = threading.Lock()
        # t_* counters: cumulative ms per stage (pack/diff host halves, the
        # chain-tail poke wait, the async dispatch call, the hostpack fetch,
        # the per-frame host stages) — the batch bench reports them so the
        # steady-state bottleneck is visible without a profiler.
        self.stats = {
            "delta_batches": 0, "full_batches": 0, "h2d_bytes": 0,
            "t_pack_ms": 0.0, "t_diff_ms": 0.0, "t_poke_ms": 0.0,
            "t_dispatch_ms": 0.0, "t_fetch_ms": 0.0, "t_host_ms": 0.0,
        }

    def _pack_rois(self, frames: list[np.ndarray]) -> np.ndarray:
        """[B, padded_roi_bytes] u8: per-frame flat ROIs — the MAP as
        PLANE-MAJOR BGR (same layout as the single-frame transport,
        tpu_backend._pack_rois_bgr: no planarizing layout copy on device),
        the button interleaved BGR. mixChannels/cvtColor write straight into
        the row views; padding rows/tails are zero. The per-frame repacks
        are independent row writes — fanned out on the host pool (a serial
        loop costs ~15-30 ms/frame at 4K, most of the batch's host half)."""
        from .tpu_backend import _DELTA_CHUNK, _cv2, _split_planes

        g = self.geom
        roi_bytes = (g.map_h * g.map_w + g.btn_h * g.btn_w) * 3
        padded = ((roi_bytes + _DELTA_CHUNK - 1) // _DELTA_CHUNK) * _DELTA_CHUNK
        out = self._rois_buf
        self._rois_buf = None
        if out is None or out.shape != (self.batch, padded):
            out = np.empty((self.batch, padded), dtype=np.uint8)
        out[len(frames) :] = 0
        out[:, roi_bytes:] = 0
        msz_p = g.map_h * g.map_w  # one plane
        msz = msz_p * 3

        def pack_one(i: int, f: np.ndarray) -> None:
            m = f[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
            b = f[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
            planes = [
                out[i, c * msz_p : (c + 1) * msz_p].reshape(g.map_h, g.map_w)
                for c in range(3)
            ]
            bdst = out[i, msz:roi_bytes].reshape(g.btn_h, g.btn_w, 3)
            _split_planes(m, planes)
            if _cv2 is not None:
                _cv2.cvtColor(b, _cv2.COLOR_BGRA2BGR, dst=bdst)
            else:
                bdst[...] = b[..., :3]

        futs = [self._pool.submit(pack_one, i, f) for i, f in enumerate(frames)]
        for fu in futs:
            fu.result()
        return out

    def _pack_rois_fused(self, frames: list[np.ndarray], diff: bool):
        """Fused native pack(+diff): one smh_pack_diff sweep per frame writes
        its row of the batch buffer while comparing against the chain
        predecessor (row i-1; row 0 against self._mirror) in registers —
        the two-pass pack-then-diff re-read of each 10-28 MB row vanishes.
        Output bytes and changed-index sets are identical to
        _pack_rois + _delta_updates' diff loop (tests pin this). Returns
        (rois, changed) with changed=None when diff is False."""
        from .. import native
        from .tpu_backend import _DELTA_CHUNK, _DELTA_SUB

        g = self.geom
        roi_bytes = (g.map_h * g.map_w + g.btn_h * g.btn_w) * 3
        padded = ((roi_bytes + _DELTA_CHUNK - 1) // _DELTA_CHUNK) * _DELTA_CHUNK
        out = self._rois_buf
        self._rois_buf = None
        if out is None or out.shape != (self.batch, padded):
            out = np.empty((self.batch, padded), dtype=np.uint8)
        out[len(frames) :] = 0
        changed: "list[np.ndarray] | None" = None
        if diff:
            n_sub = padded // _DELTA_SUB
            scratch = self._diff_scratch
            if scratch is None or scratch.size < n_sub:
                scratch = self._diff_scratch = np.empty(n_sub, np.int32)
            dirty = self._dirty_scratch
            if dirty is None or dirty.size < n_sub:
                dirty = self._dirty_scratch = np.empty(n_sub, np.uint8)
            changed = []
        def rois(f):
            return (
                f[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w],
                f[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w],
            )

        if not diff:
            # Independent row packs: fan out on the host pool exactly like
            # _pack_rois (a serial loop costs ~15-30 ms/frame at 4K; only
            # the diff=True chain below is inherently sequential).
            futs = [
                self._pool.submit(
                    lambda m, b, row: native.pack_diff(m, b, row, None, None, None),
                    *rois(f), out[i],
                )
                for i, f in enumerate(frames)
            ]
            for fu in futs:
                fu.result()
            return out, None
        prev = self._mirror
        for i, f in enumerate(frames):
            m, b = rois(f)
            cnt = native.pack_diff(m, b, out[i], prev, dirty, scratch)
            changed.append(
                np.zeros(1, dtype=np.int32) if cnt == 0 else scratch[:cnt].copy()
            )
            prev = out[i]
        return out, changed

    def _roll_delta(self, frames: list[np.ndarray]):
        """Rolling fused pack+diff+gather for the batch delta path: the
        chain mirror rolls frame-to-frame IN PLACE (native pack_diff_roll),
        so unchanged windows are compared in registers and never stored —
        the batch buffer write, the mirror read, and the end-of-submit
        mirror copy of the two-pass path all vanish (the per-frame path's
        pack_diff_roll applied across the batch). Each frame's changed
        chunks are gathered out of the rolling buffer before the next
        frame overwrites them. Returns (buf, bucket) with bytes identical
        to _delta_updates over _pack_rois rows (pinned by tests), or None
        when any frame overflows the delta ladder — the caller must then
        reseed via the full batch upload (the mirror is mid-roll stale).
        """
        from .tpu_backend import _DELTA_SUB, _delta_bucket

        native = self._native
        g = self.geom
        w = self._mirror
        n_sub = w.size // _DELTA_SUB
        scratch = self._diff_scratch
        if scratch is None or scratch.size < n_sub:
            scratch = self._diff_scratch = np.empty(n_sub, np.int32)
        dirty = self._dirty_scratch
        if dirty is None or dirty.size < n_sub:
            dirty = self._dirty_scratch = np.empty(n_sub, np.uint8)
        tmps: list[tuple[int, np.ndarray]] = []
        for f in frames:
            m = f[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
            b = f[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
            cnt = native.pack_diff_roll(m, b, w, dirty, scratch)
            if cnt == 0:
                scratch[0] = 0  # no-op keepalive chunk (flags may differ)
                cnt = 1
            if _delta_bucket(cnt, n_sub) is None:
                return None  # ladder overflow: full upload wins
            tmp = np.empty(cnt * 4 + cnt * _DELTA_SUB, dtype=np.uint8)
            native.gather_subchunks(w, scratch, cnt, cnt, tmp)
            tmps.append((cnt, tmp))
        bucket = _delta_bucket(max(c for c, _ in tmps), n_sub)
        assert bucket is not None  # every frame passed individually
        bsz = self.batch
        buf = np.empty(bsz * bucket * 4 + bsz * bucket * _DELTA_SUB, np.uint8)
        idxs = buf[: bsz * bucket * 4].view(np.int32).reshape(bsz, bucket)
        datas = buf[bsz * bucket * 4 :].reshape(bsz, bucket, _DELTA_SUB)
        for i in range(bsz):
            if i < len(tmps):
                cnt, tmp = tmps[i]
                ti = tmp[: cnt * 4].view(np.int32)
                td = tmp[cnt * 4 :].reshape(cnt, _DELTA_SUB)
                idxs[i, :cnt] = ti
                idxs[i, cnt:] = ti[-1]
                datas[i, :cnt] = td
                datas[i, cnt:] = td[-1]
            else:
                # Padding rows replay chunk 0 of the last frame — exactly
                # _delta_updates' ch=zeros(1) over rois[n-1].
                idxs[i, :] = 0
                datas[i, :] = w[:_DELTA_SUB]
        return buf, bucket

    def _fused_ok(self, frames: list[np.ndarray]) -> bool:
        import os as _os

        if self._native is None or _os.environ.get("SMH_NATIVE_PACK", "1") == "0":
            return False
        return all(
            f.ndim == 3 and f.shape[2] == 4 and f.dtype == np.uint8
            and f.strides[2] == 1 and f.strides[1] == 4
            for f in frames
        )

    def _find_lines(self, crop_mask: np.ndarray, offset: tuple[int, int]) -> list[Line]:
        if crop_mask.size == 0:
            return []
        g = self.geom
        full = (g.map_h, g.map_w)
        if self._native is not None:
            return self._native.find_lines(
                crop_mask, C.LSD_MAX_GAP, full_shape=full, offset=offset
            )
        # Oracle fallback has no windowed view: paste into a full canvas so
        # coordinates (and f32 march arithmetic) stay in full-plane space.
        ox, oy = offset
        if crop_mask.shape == full and (ox, oy) == (0, 0):
            canvas = crop_mask
        else:
            canvas = np.zeros(full, dtype=np.uint8)
            canvas[oy : oy + crop_mask.shape[0], ox : ox + crop_mask.shape[1]] = crop_mask
        return vlsd.find_lines(canvas, C.LSD_MAX_GAP, oracle_march)

    def _host_ratio(self, ocr_img, scales_img, lazy_scales_img=None):
        """Host engine + bar walk over materialized planes (the non-device
        path, and the device path's overflow fallback)."""
        with self._ocr_lock:  # engine singletons are not re-entrant
            ocr_results = self.ocr_engine.read(ocr_img, None)
        from .pipeline import _parse_scales

        scales, start_y = _parse_scales(ocr_results)
        if not scales or start_y is None:
            return None
        if scales_img is None:
            scales_img = lazy_scales_img()
        return mpx.calc_meters_to_px_ratio(scales, scales_img)

    def _delta_updates(self, rois: np.ndarray, n: int,
                       changed: "list[np.ndarray] | None" = None):
        """Per-frame changed-chunk updates against the chain, or None when a
        frame changed too much (the full batch upload wins). `changed` may
        carry the per-frame index sets the fused pack+diff already computed
        (identical to what the loops below produce)."""
        from .tpu_backend import (
            _DELTA_CHUNK,
            _DELTA_SUB,
            _delta_bucket,
            _refine_subchunks,
        )

        # Two-level diff, shared with the per-frame backend: compare at
        # 128 B, refine to 32 B sub-chunks. The native engine emits the
        # identical index set at memory speed (no bool temporaries); numpy
        # is the fallback.
        n_chunks = rois.shape[1] // _DELTA_CHUNK
        n_sub = n_chunks * (_DELTA_CHUNK // _DELTA_SUB)
        if changed is not None:
            assert len(changed) == n
        elif self._native is not None:
            changed = []
            scratch = self._diff_scratch
            if scratch is None or scratch.size < n_sub:
                scratch = self._diff_scratch = np.empty(n_sub, np.int32)
            prev = self._mirror
            for i in range(n):
                cnt = self._native.diff_subchunks(rois[i], prev, scratch)
                if cnt == 0:
                    changed.append(np.zeros(1, dtype=np.int32))
                else:
                    changed.append(scratch[:cnt].copy())
                prev = rois[i]
        else:
            changed = []
            prev64 = self._mirror.view(np.uint64).reshape(n_chunks, -1)
            for i in range(n):
                cur64 = rois[i].view(np.uint64).reshape(n_chunks, -1)
                ne = cur64 != prev64
                ch = np.flatnonzero(ne.any(axis=1)).astype(np.int32)
                changed.append(_refine_subchunks(ne, ch))
                prev64 = cur64
        bucket = _delta_bucket(max(c.size for c in changed), n_sub)
        if bucket is None:
            return None
        b = self.batch
        buf = np.empty(b * bucket * 4 + b * bucket * _DELTA_SUB, dtype=np.uint8)
        if self._native is not None:
            # The batch layout groups idx tables for ALL frames first, then
            # all payload blocks; the C gather emits [idx | data] per frame,
            # so gather into a small per-frame tmp and split (bucket*36 B,
            # trivial next to the diff itself).
            idxs_bytes = buf[: b * bucket * 4]
            datas = buf[b * bucket * 4 :]
            for i in range(b):
                ch = changed[i] if i < n else np.zeros(1, dtype=np.int32)
                src = rois[min(i, n - 1)]
                tmp = np.empty(bucket * 4 + bucket * _DELTA_SUB, dtype=np.uint8)
                self._native.gather_subchunks(src, ch, int(ch.size), bucket, tmp)
                idxs_bytes[i * bucket * 4 : (i + 1) * bucket * 4] = tmp[: bucket * 4]
                datas[i * bucket * _DELTA_SUB : (i + 1) * bucket * _DELTA_SUB] = (
                    tmp[bucket * 4 :]
                )
        else:
            idxs = buf[: b * bucket * 4].view(np.int32).reshape(b, bucket)
            datas = buf[b * bucket * 4 :].reshape(b, bucket, _DELTA_SUB)
            for i in range(b):
                ch = changed[i] if i < n else np.zeros(1, dtype=np.int32)
                src = rois[min(i, n - 1)].reshape(n_sub, _DELTA_SUB)
                idxs[i, : ch.size] = ch
                idxs[i, ch.size :] = ch[-1]
                datas[i, : ch.size] = src[ch]
                datas[i, ch.size :] = src[ch[-1]]
        return buf, bucket

    def process(self, frames: list[np.ndarray]) -> list[BatchResult]:
        """frames: BGRA u8 arrays of the pipeline resolution, len <= batch."""
        return self.collect(self.submit(frames))

    def stream(self, batches, depth: int = 2):
        """Yield collect() results for an iterable of frame batches,
        overlapping batch N+1's submit half (pack + diff + dispatch, on a
        worker thread) with batch N's collect half (hostpack fetch + host
        stages, on the caller thread). The fetch wait and the submit's
        chain-tail barrier run under released GILs while the other thread
        does CPU work.
        `depth` bounds in-flight batches (submit order = chain order is
        preserved by the single worker; results yield in the same order).
        Abandoning the generator early (break / exception / close) is safe:
        the submitter stops at the next batch boundary and every job it
        already dispatched is collected (not yielded) so no device program
        is left un-fetched and the materialization tracking stays exact."""
        import queue

        jobs: queue.Queue = queue.Queue(maxsize=max(1, depth))
        done = object()
        stop = threading.Event()

        def submitter() -> None:
            try:
                for fr in batches:
                    if stop.is_set():
                        break
                    job = self.submit(fr)
                    # Blocking put with a stop check: when the consumer
                    # abandoned the generator it drains the queue in its
                    # finally block, so this always makes progress.
                    while True:
                        try:
                            jobs.put(job, timeout=0.2)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # propagate into the consumer
                jobs.put(("__stream_err__", e))
            else:
                jobs.put(done)

        def drain_one(block: bool) -> bool:
            try:
                j = jobs.get(timeout=0.05) if block else jobs.get_nowait()
            except queue.Empty:
                return False
            if j is not done and not (
                isinstance(j, tuple) and j and j[0] == "__stream_err__"
            ):
                self.collect(j)
            return True

        t = threading.Thread(target=submitter, daemon=True, name="batch-submit")
        t.start()
        try:
            while True:
                j = jobs.get()
                if j is done:
                    break
                if isinstance(j, tuple) and j and j[0] == "__stream_err__":
                    raise j[1]
                yield self.collect(j)
        finally:
            stop.set()
            while t.is_alive():
                drain_one(block=True)
                t.join(timeout=0.05)
            while drain_one(block=False):
                pass

    def submit(self, frames: list[np.ndarray]) -> dict:
        """Pack + diff + dispatch a batch WITHOUT waiting for results.

        The returned job is consumed by collect(). Submitting batch N+1
        while batch N is still in flight overlaps N+1's host half (ROI
        repack ~100 ms, u64 diff ~30 ms at 4K) and its H2D with N's device
        compute and fetch — the pipelined shape of tools/analyze_video.py
        and the bench's stream metric. The delta chain stays correct under
        pipelining: the diff base is the last SUBMITTED batch's tail (host
        mirror), and the device resident buffer advances in submit order.
        """
        from .tpu_backend import _DELTA_CHUNK, _DELTA_MIN_BYTES, _DELTA_SUB

        g = self.geom
        assert frames and len(frames) <= self.batch
        n = len(frames)
        roi_bytes = (g.map_h * g.map_w + g.btn_h * g.btn_w) * 3
        padded = ((roi_bytes + _DELTA_CHUNK - 1) // _DELTA_CHUNK) * _DELTA_CHUNK
        delta_ok = (
            self.mesh is None  # see __init__: no cross-chip scan chains
            and self.delta_mode not in ("0", "off")
            and (self.delta_mode in ("1", "on") or padded >= _DELTA_MIN_BYTES)
            and self._resident is not None
            and self._mirror is not None
            and self._mirror.size == padded
        )
        import os as _os

        t0 = time.perf_counter()
        changed = None
        rois = None
        upd = None
        rolled = False
        fused = self._fused_ok(frames)
        if fused and delta_ok and _os.environ.get("SMH_BATCH_ROLL", "1") != "0":
            # Rolling in-place pack+diff+gather: no batch buffer write for
            # unchanged windows, no mirror copy. t_pack_ms carries the
            # whole sweep (diff is fused into it; t_diff_ms stays ~0).
            upd = self._roll_delta(frames)
            rolled = upd is not None
            if not rolled:
                delta_ok = False  # ladder overflow mid-roll: reseed full
        if not rolled:
            if fused:
                # t_pack_ms then carries the fused pack+diff sweep; the
                # residual t_diff_ms is bucket selection + gather only.
                rois, changed = self._pack_rois_fused(frames, diff=delta_ok)
            else:
                rois = self._pack_rois(frames)
        t1 = time.perf_counter()
        self.stats["t_pack_ms"] += (t1 - t0) * 1000.0

        with_ocr = self.ocr_engine is not None
        # Batch mode is one fetch per batch. Device-capable engines (smhocr
        # semantics) ride the ~1.2 KB record transport — the device reads every
        # frame's scales itself and host OCR vanishes from the batch loop
        # (fallback to the engine over that frame's scalespack on capacity
        # overflow). Others get the images inline (bit-packed if binary_ok).
        inline = "none"
        if with_ocr:
            if (
                getattr(self.ocr_engine, "device_ok", False)
                and _os.environ.get("SMH_DEVICE_SCALES", "1") != "0"
            ):
                inline = "device"
            elif getattr(self.ocr_engine, "binary_ok", False):
                inline = "binary"
            else:
                inline = "gray"
        kw = dict(
            map_h=g.map_h,
            map_w=g.map_w,
            btn_h=g.btn_h,
            btn_w=g.btn_w,
            grayscale=True,
            with_ocr=with_ocr,
            crop_h=self.crop_h,
            crop_w=self.crop_w,
            scales_inline=inline,
            channels=3,
            sparse_budget=self.sparse_budget,
        )
        if not rolled:
            upd = self._delta_updates(rois, n, changed) if delta_ok else None
        t2 = time.perf_counter()
        self.stats["t_diff_ms"] += (t2 - t1) * 1000.0
        if upd is not None:
            buf, bucket = upd
            # Pipelined delta chains must not stack unboundedly many
            # dispatches against unmaterialized residents (scan-over-scan
            # dependency chains). Barrier = at most TWO unmaterialized
            # batch programs when dispatching a delta (the per-frame
            # driver's barrier is gated on >=3). In the steady depth-2
            # stream exactly one batch is outstanding at submit time, so
            # the barrier never fires there: an eager per-batch wait would
            # serialize the pipeline on the fetch latency being hidden.
            # When it does fire, it polls is_ready() (wait_ready).
            # SMH_BATCH_BARRIER=eager waits on ANY outstanding program,
            # for A/B probes.
            gate = 1 if _os.environ.get("SMH_BATCH_BARRIER") == "eager" else 2
            if self._seq - self._fetched_seq >= gate:
                from .tpu_backend import wait_ready

                wait_ready(self._resident)
            t3 = time.perf_counter()
            self.stats["t_poke_ms"] += (t3 - t2) * 1000.0
            out = dict(ops_pipeline._analyze_batch_delta(
                self._resident, buf, bucket=bucket, chunk=_DELTA_SUB, **kw
            ))
            self.stats["t_dispatch_ms"] += (time.perf_counter() - t3) * 1000.0
            self.stats["delta_batches"] += 1
            self.stats["h2d_bytes"] += buf.size
            if rois is not None:
                self._rois_buf = rois  # never left the host: recycle next batch
        else:
            rois_in = rois
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                rois_in = jax.device_put(rois, NamedSharding(self.mesh, P("dp")))
            t3 = time.perf_counter()
            out = dict(ops_pipeline._analyze_batch_packed(
                rois_in, resident_row=n - 1, **kw
            ))
            self.stats["t_dispatch_ms"] += (time.perf_counter() - t3) * 1000.0
            self.stats["full_batches"] += 1
            self.stats["h2d_bytes"] += rois.size
        self._resident = out.pop("resident")
        # Start the batch hostpack's D2H immediately: it lands in the
        # background while the next batch packs/diffs, so collect()'s
        # np.asarray reads landed bytes instead of waiting on the transfer.
        from .tpu_backend import start_fetch

        start_fetch(out["hostpack"])
        # Copy: a row view would keep the whole packed batch (~80 MB at 4K,
        # B=8) alive in host RAM until the next submit replaces it. The
        # rolled path's mirror IS the chain tail already (rolled in place).
        if not rolled:
            self._mirror = rois[n - 1].copy()
        self._seq += 1
        return {
            "out": out, "n": n, "inline": inline, "with_ocr": with_ocr,
            "seq": self._seq,
        }

    def collect(self, job: dict) -> list[BatchResult]:
        """Fetch + host stages for a submitted batch (blocks on the device)."""
        g = self.geom
        out = job["out"]
        n = job["n"]
        inline = job["inline"]
        with_ocr = job["with_ocr"]
        t0 = time.perf_counter()
        packs = np.asarray(out["hostpack"])  # ONE fetch for the whole batch
        t1 = time.perf_counter()
        self.stats["t_fetch_ms"] += (t1 - t0) * 1000.0
        with self._fetch_lock:
            self._fetched_seq = max(self._fetched_seq, job.get("seq", 0))
        layout = ops_pipeline.hostpack_layout(
            g.map_h, g.map_w, with_ocr=with_ocr, with_quiet=True,
            crop_h=self.crop_h, crop_w=self.crop_w, scales_inline=inline,
            sparse_budget=self.sparse_budget,
        )
        eff_ch = g.map_h if self.crop_h is None else self.crop_h
        eff_cw = g.map_w if self.crop_w is None else self.crop_w
        mask_row = (g.map_w + 7) // 8
        crop_row = (eff_cw + 7) // 8
        margin = ops_pipeline.LSD_CROP_MARGIN

        def sect(i, name):
            off, size = layout[name]
            return packs[i, off : off + size]

        # Pass 1 (host, cheap): red gates, bboxes, window misses, checksum set.
        active: list[int] = []
        meta = {}
        misses: list[int] = []
        for i in range(n):
            red = float(sect(i, "red_ratio").view(np.float32)[0])
            if red < C.CLOSE_DEPLOYMENT_BUTTON_RED_PIXEL_THRESHOLD:
                continue
            active.append(i)
            y0, y1, x0, x1, cy0, cx0 = (int(v) for v in sect(i, "lsd_meta").view(np.int32))
            empty = y0 >= y1 or x0 >= x1
            if self.sparse_budget is not None:
                nz = int(sect(i, "lsd_nz").view(np.int32)[0])
                fit = (not empty) and nz <= self.sparse_budget
            else:
                fit = (not empty) and (
                    cy0 + eff_ch >= min(y1 + margin, g.map_h)
                    and cx0 + eff_cw >= min(x1 + margin, g.map_w)
                )
            if not empty and not fit:
                misses.append(i)
            check = None
            if with_ocr:
                check = tuple(int(v) for v in sect(i, "scales_check").view(np.uint32))
            meta[i] = (empty, fit, (y0, y1, x0, x1), (cx0, cy0), check)

        # Window misses: ONE batched fetch of the full bit-masks involved.
        full_bits = {}
        if misses:
            fetched = np.asarray(out["lsd_bits"][np.asarray(misses)])
            for k, i in enumerate(misses):
                full_bits[i] = fetched[k]


        def host_stage(i: int) -> BatchResult:
            empty, fit, bbox, (cx0, cy0), check = meta[i]
            # Unpack/scan only the mask bbox + margin (exact; see
            # ops_pipeline.bbox_crop_host) — the LSD stage cost tracks
            # content area, not window area.
            if empty:
                markers: list[Line] = []
            elif fit and self.sparse_budget is not None:
                bits = ops_pipeline.sparse_mask_host(
                    int(sect(i, "lsd_nz").view(np.int32)[0]),
                    sect(i, "lsd_sp_idx").view(np.int32),
                    sect(i, "lsd_sp_dat").view(np.uint32),
                    g.map_h,
                    g.map_w,
                )
                crop, off = ops_pipeline.bbox_crop_host(
                    bits, bbox, (0, 0), (g.map_h, g.map_w)
                )
                markers = self._find_lines(crop, off)
            elif fit:
                bits = sect(i, "lsd_crop").reshape(eff_ch, crop_row)
                crop, off = ops_pipeline.bbox_crop_host(
                    bits, bbox, (cx0, cy0), (eff_ch, eff_cw)
                )
                markers = self._find_lines(crop, off)
            else:
                crop, off = ops_pipeline.bbox_crop_host(
                    full_bits[i].reshape(g.map_h, mask_row), bbox, (0, 0),
                    (g.map_h, g.map_w),
                )
                markers = self._find_lines(crop, off)

            l, t, r, b = (int(v) for v in sect(i, "minimap_rect").view(np.int32))
            minimap = Rect(left=l, top=t, right=r, bottom=b) if g.map_w >= 3 and g.map_h >= 3 else None

            ratio = None
            if with_ocr:
                if check in self._scales_cache:
                    ratio = self._scales_cache[check]
                else:
                    brq_row = (g.brq_w + 7) // 8
                    if inline == "device":
                        from ..ops import scales_device as sdv

                        dev = sdv.decode_records(sect(i, "scales_rec").view(np.int16))
                        ratio = sdv.ratio_from_records(dev)
                        if ratio is None and not dev.complete:
                            # capacity overflow with nothing trusted: host
                            # engine over THIS frame's scalespack (one lazy
                            # per-frame fetch; rare)
                            spack = np.asarray(out["scalespack"][i])
                            slay = ops_pipeline.scalespack_layout(g.map_h, g.map_w)
                            so, ss = slay["scales_bits"]
                            oo, os_ = slay["ocr_img"]
                            ocr_img = spack[oo : oo + os_].reshape(g.brq_h, g.brq_w)
                            scales_img = ops_pipeline.unpack_bits_host(
                                spack[so : so + ss].reshape(g.brq_h, brq_row), g.brq_w
                            ) * np.uint8(255)
                            ratio = self._host_ratio(ocr_img, scales_img)
                    else:
                        if inline == "binary":
                            ocr_img = ops_pipeline.binary_ocr_image_host(
                                sect(i, "ocr_bits").reshape(g.brq_h, brq_row), g.brq_w
                            )
                        else:
                            ocr_img = sect(i, "ocr_img").reshape(g.brq_h, g.brq_w)
                        scales_img = None

                        def lazy_scales_img():
                            return ops_pipeline.unpack_bits_host(
                                sect(i, "scales_bits").reshape(g.brq_h, brq_row),
                                g.brq_w,
                            ) * np.uint8(255)

                        ratio = self._host_ratio(ocr_img, None, lazy_scales_img)
                    if len(self._scales_cache) > 256:
                        self._scales_cache.clear()
                    self._scales_cache[check] = ratio

            return BatchResult(False, markers, minimap, ratio)

        futures = {i: self._pool.submit(host_stage, i) for i in active}
        results: list[BatchResult] = []
        for i in range(n):
            if i in futures:
                results.append(futures[i].result())
            else:
                results.append(BatchResult(True, [], None, None))
        self.stats["t_host_ms"] += (time.perf_counter() - t1) * 1000.0
        return results

    def close(self) -> None:
        self._pool.shutdown(wait=False)
