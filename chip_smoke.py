"""Chip smoke: the vision pipeline on one GPU, through the entry points a
user calls, against the numpy oracle (smh_tpu/vision/reference.py).

    python chip_smoke.py

Phases, in order; each prints one JSON line, and any failed check ends the
run with a non-zero exit and no "ok" line:

  a. worker, 4K: WorkerClient (the `app --worker` path) takes 8 distinct
     frames through its shm ring; this process has not opened JAX yet, and
     the worker has exited before phase b starts (one process per card).
  b. live loop at 4K and 1080p: CaptureThread -> VisionLoop -> VisionState
     with SmhOcrEngine and hardware_acceleration on, 4 distinct frames each.
  c. batch, 4K, B=16: BatchPipeline.stream over 48 video-like frames (the
     delta chain engaged).
  d. device ray march, 4K: TpuBackend(lsd_engine="tpu").
  e. fused-pass parity, 4K: ui/OCR/scales planes exact, marker mask >=
     99.9%, device glyph classification vs a float64 evaluation of the same
     features, and the fused bucket's compiled memory analysis.

Detection tolerance (tests/test_tpu_parity.py): the same number of lines,
endpoints within 1.5 px, the ratio within 1e-6 relative, the same minimap
rect. The card's name and power limit are read with nvidia-smi, and JAX's
platform is checked from a child process, before this process touches JAX.
The last line is {"ok": true, "device": {...}} as JAX reports the device.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import pathlib
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from smh_tpu import consts as C, device_info, testing  # noqa: E402
from smh_tpu.ocr import glyphs  # noqa: E402

RES = {"4k": (3840, 2160), "1080p": (1920, 1080)}
LINE_TOL_PX = 1.5
RATIO_RTOL = 1e-6
MASK_AGREEMENT = 0.999
SCORE_TOL = 1e-5


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=str), flush=True)


# -- frames and the oracle -----------------------------------------------------


def smoke_frames(w: int, h: int, n: int) -> list[np.ndarray]:
    """n distinct BGRA frames: two marker lines, a "300m" label and a scale
    bar right below it, placed in proportion to the map so that every
    resolution from 640x360 up carries them."""
    g = C.map_geometry(w, h)
    text_bottom = int(np.nonzero(glyphs.text_mask("300m"))[0].max()) + 1
    bar_w = max(24, g.brq_w // 8)
    frames = []
    for i in range(n):
        off = i * max(2, g.map_w // 200)
        tx = g.brq_w // 16 + 2 * i
        ty = g.brq_h // 5
        frames.append(testing.make_frame(
            w, h,
            marker_lines=[
                ((g.map_w * 6 // 100 + off, g.map_h * 9 // 100),
                 (g.map_w * 35 // 100 + off, g.map_h * 32 // 100)),
                ((g.map_w // 4, g.map_h // 2 + off),
                 (g.map_w * 48 // 100, g.map_h * 55 // 100 + off)),
            ],
            scale_texts=[("300m", (tx, ty))],
            scale_bars=[(tx, ty + text_bottom + 2, bar_w, 1)],
        ))
    return frames


def summarize(res) -> dict:
    """Detections of one frame as plain data (VisionResults, BatchResult
    or None for a sleeping frame)."""
    if res is None or getattr(res, "sleeping", False):
        return {"sleeping": True}
    mb = res.minimap_bounds
    return {
        "sleeping": False,
        "markers": [[l.p0.x, l.p0.y, l.p1.x, l.p1.y] for l in res.markers],
        "ratio": res.meters_to_px_ratio,
        "minimap": None if mb is None else [mb.left, mb.top, mb.right, mb.bottom],
    }


def _oracle_one(frame: np.ndarray) -> dict:
    from smh_tpu.ocr.smhocr import SmhOcrEngine
    from smh_tpu.settings import Settings
    from smh_tpu.squadex.capture import Frame
    from smh_tpu.vision.pipeline import VisionState

    settings = Settings(path=None)
    settings.set("hardware_acceleration", False)
    state = VisionState(settings=settings, ocr_engine=SmhOcrEngine())
    try:
        return summarize(state.process(Frame(frame, 96)))
    finally:
        state.close()


def oracle(frames: list[np.ndarray], workers: int) -> list[dict]:
    """The numpy oracle's detections, frame by frame (no JAX involved)."""
    if workers <= 1:
        return [_oracle_one(f) for f in frames]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        return list(pool.map(_oracle_one, frames))


def compare(got: dict, want: dict, where: str) -> float:
    """Assert detection agreement within the parity bands; returns the
    largest endpoint difference in px."""
    check(got["sleeping"] == want["sleeping"], f"{where}: sleeping {got} vs oracle {want}")
    if want["sleeping"]:
        return 0.0
    a = sorted(got["markers"])
    b = sorted(want["markers"])
    check(len(a) == len(b), f"{where}: {len(a)} lines vs oracle {len(b)}: {a} / {b}")
    worst = max((abs(x - y) for la, lb in zip(a, b) for x, y in zip(la, lb)), default=0.0)
    check(worst <= LINE_TOL_PX, f"{where}: endpoints differ by {worst} px: {a} / {b}")
    ra, rb = got["ratio"], want["ratio"]
    check((ra is None) == (rb is None), f"{where}: ratio {ra} vs oracle {rb}")
    if rb is not None:
        check(abs(ra - rb) <= RATIO_RTOL * abs(rb), f"{where}: ratio {ra} vs oracle {rb}")
    check(got["minimap"] == want["minimap"], f"{where}: minimap {got['minimap']} vs oracle {want['minimap']}")
    return float(worst)


# -- phases ----------------------------------------------------------------------


def phase_worker(w: int, h: int, n_frames: int, oracle_workers: int,
                 timeout_s: float = 900.0) -> dict:
    """a. The pipeline worker process across its shm ring and socket."""
    from smh_tpu.worker import WorkerClient

    frames = smoke_frames(w, h, n_frames)
    want = oracle(frames, oracle_workers)
    results: dict[int, dict] = {}
    cond = threading.Condition()

    def on_result(msg: dict) -> None:
        with cond:
            results[msg["seq"]] = msg
            cond.notify_all()

    t0 = time.perf_counter()
    wc = WorkerClient(w, h, on_result)
    try:
        check(wc.wait_ready_progress(idle_timeout=300.0, max_s=timeout_s),
              f"worker not ready: {wc.diagnose()}")
        ready_s = time.perf_counter() - t0
        worst = 0.0
        for i, frame in enumerate(frames):
            seq = wc.submit(frame)
            check(seq is not None, f"worker refused frame {i}: {wc.diagnose()}")
            deadline = time.monotonic() + timeout_s
            with cond:
                while seq not in results:
                    left = deadline - time.monotonic()
                    check(left > 0, f"no worker result for frame {i}: {wc.diagnose()}")
                    cond.wait(min(left, 5.0))
                msg = results.pop(seq)
            got = {"sleeping": msg["sleeping"]}
            if not msg["sleeping"]:
                got.update(markers=msg["markers"], ratio=msg["ratio"], minimap=msg["minimap"])
            worst = max(worst, compare(got, want[i], f"worker frame {i}"))
        restarts = wc.restarts
        check(restarts == 0, f"worker restarted {restarts} times")
    finally:
        wc.close()
    proc = wc._proc
    check(proc is None or proc.poll() is not None, "worker process still running after close")
    return {"frames": n_frames, "ready_s": ready_s, "restarts": restarts,
            "max_endpoint_diff_px": worst, "worker_exit_code": proc.poll() if proc else None}


class _StepSource:
    """Hands out frames[k] until the loop reports a result for it, then the
    next: every distinct frame is processed exactly once, in order."""

    def __init__(self, frames: list[np.ndarray]) -> None:
        self.frames = frames
        self.k = 0

    def grab(self):
        from smh_tpu.squadex.capture import Frame

        return Frame(self.frames[min(self.k, len(self.frames) - 1)], 96)


def phase_live(w: int, h: int, n_frames: int, oracle_workers: int,
               expect_platform: str = "gpu", timeout_s: float = 900.0) -> dict:
    """b. The live loop: CaptureThread -> VisionLoop -> VisionState."""
    import jax

    from smh_tpu.ocr.smhocr import SmhOcrEngine
    from smh_tpu.settings import Settings
    from smh_tpu.squadex.capture import CaptureThread
    from smh_tpu.vision import tpu_backend
    from smh_tpu.vision.pipeline import VisionLoop, VisionState

    frames = smoke_frames(w, h, n_frames)
    want = oracle(frames, oracle_workers)
    settings = Settings(path=None)
    settings.set("hardware_acceleration", True)
    state = VisionState(settings=settings, ocr_engine=SmhOcrEngine())
    src = _StepSource(frames)
    got: list[dict] = []
    done = threading.Event()
    times: list[float] = []

    def on_update(res, debug) -> None:
        if res is None or done.is_set():
            return
        got.append(summarize(res))
        times.append(time.perf_counter())
        src.k += 1
        if len(got) == n_frames:
            done.set()

    t0 = time.perf_counter()
    cap = CaptureThread(src, hz=20).start()
    loop = VisionLoop(state, cap, on_update).start()
    try:
        check(done.wait(timeout_s), f"live loop produced {len(got)}/{n_frames} results")
    finally:
        loop.stop()
        cap.stop()
    be = state.delegate.backend
    state.close()
    check(isinstance(be, tpu_backend.TpuBackend), f"live loop ran on {type(be).__name__}")
    platform = jax.devices()[0].platform
    check(platform == expect_platform, f"live loop platform {platform!r}")
    worst = max(compare(g, wnt, f"live {w}x{h} frame {i}") for i, (g, wnt) in enumerate(zip(got, want)))
    st = be.stats
    check(st["device_scales_frames"] >= 1, f"no device scales read: {st}")
    check(st["device_scales_fallbacks"] == 0, f"device scales fell back: {st}")
    return {
        "res": f"{w}x{h}", "frames": n_frames, "backend": be.name, "platform": platform,
        "lsd_engine": be.lsd_engine, "first_frame_s": times[0] - t0,
        "device_scales_frames": st["device_scales_frames"],
        "device_scales_fallbacks": st["device_scales_fallbacks"],
        "lsd_sparse_misses": st["lsd_sparse_misses"],
        "lsd_window_misses": st["lsd_window_misses"],
        "scales_band_misses": st["scales_band_misses"],
        "max_endpoint_diff_px": worst,
    }


def phase_batch(frames: list[np.ndarray], batch: int, oracle_workers: int) -> dict:
    """c. BatchPipeline.stream over a video-like sequence of frames."""
    from smh_tpu.ocr.smhocr import SmhOcrEngine
    from smh_tpu.vision.batch import BatchPipeline

    h, w = frames[0].shape[:2]
    n_frames = len(frames)
    want = oracle(frames, oracle_workers)
    bp = BatchPipeline(w, h, batch=batch, ocr_engine=SmhOcrEngine())
    t0 = time.perf_counter()
    try:
        batches = [frames[i : i + batch] for i in range(0, n_frames, batch)]
        got = [summarize(r) for rs in bp.stream(iter(batches)) for r in rs]
        stream_s = time.perf_counter() - t0
        stats = dict(bp.stats)
    finally:
        bp.close()
    check(len(got) == n_frames, f"batch returned {len(got)}/{n_frames} results")
    worst = max(compare(g, wnt, f"batch frame {i}") for i, (g, wnt) in enumerate(zip(got, want)))
    check(stats["delta_batches"] >= 1, f"delta chain never engaged: {stats}")
    return {"res": f"{w}x{h}", "batch": batch, "frames": n_frames,
            "delta_batches": stats["delta_batches"], "full_batches": stats["full_batches"],
            "stream_s": stream_s, "max_endpoint_diff_px": worst}


def phase_device_march(w: int, h: int) -> dict:
    """d. The device ray march (hosts without the native march)."""
    from smh_tpu.vision import find_minimap as fm
    from smh_tpu.vision.reference import ReferenceBackend
    from smh_tpu.vision.tpu_backend import TpuBackend

    frame = smoke_frames(w, h, 1)[0]
    ref = ReferenceBackend()
    ref.load_frame(frame)
    check(ref.crop_to_map(True) is not None, "oracle sleeps on the smoke frame")
    ref.isolate_map_markers()
    ref.mask_marker_lines()
    want_lines = ref.find_marker_lines(C.LSD_MAX_GAP)
    g = C.map_geometry(w, h)
    want_rect = fm.find_minimap(frame[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w])

    be = TpuBackend(lsd_engine="tpu")
    be.load_frame(frame)
    check(be.crop_to_map(True) is not None, "device sleeps on the smoke frame")
    lines = be.find_marker_lines(C.LSD_MAX_GAP)
    rect = be.minimap_rect()

    def plain(lines_, rect_):
        return {"sleeping": False, "ratio": None,
                "markers": [[l.p0.x, l.p0.y, l.p1.x, l.p1.y] for l in lines_],
                "minimap": None if rect_ is None else [rect_.left, rect_.top, rect_.right, rect_.bottom]}

    worst = compare(plain(lines, rect), plain(want_lines, want_rect), f"device march {w}x{h}")
    return {"res": f"{w}x{h}", "lsd_engine": be.lsd_engine, "lines": len(lines),
            "max_endpoint_diff_px": worst}


def phase_fused_parity(w: int, h: int, memory_analysis: bool = True) -> dict:
    """e. The fused pass's planes against the oracle, the device glyph
    classification against float64, and the bucket's memory analysis."""
    import jax
    import jax.numpy as jnp

    from smh_tpu.ops import hsv as jhsv
    from smh_tpu.ops import scales_device as sd
    from smh_tpu.vision import pixmath as pm
    from smh_tpu.vision.reference import ReferenceBackend
    from smh_tpu.vision.tpu_backend import TpuBackend

    frame = smoke_frames(w, h, 1)[0]
    ref = ReferenceBackend()
    ref.load_frame(frame)
    ui_ref, bbox_ref = ref.crop_to_map(grayscale=True)
    ref.isolate_map_markers()
    ref.mask_marker_lines()
    ocr_ref = ref.ocr_preprocess()
    scales_ref = ref.find_scales_preprocess(0)

    be = TpuBackend()  # gray inline transport: the full OCR image comes back
    be.load_frame(frame)
    out = be.crop_to_map(grayscale=True)
    check(out is not None, "device sleeps on the smoke frame")
    ui_fn, bbox = out
    ui = ui_fn()
    mask = be._full_mask_host()
    ocr_img = be.ocr_preprocess()
    scales_img = be.find_scales_preprocess(0)

    check(bbox == bbox_ref, f"map bbox {bbox} vs oracle {bbox_ref}")
    check(bool((ui == ui_ref).all()), "ui plane differs from the oracle")
    check(bool((ocr_img == ocr_ref).all()), "OCR image differs from the oracle")
    check(bool((scales_img == scales_ref).all()), "scales binarize differs from the oracle")
    mask_agree = float((mask == ref.lsd_image).mean())
    check(mask_agree >= MASK_AGREEMENT, f"marker mask agreement {mask_agree}")

    # h/s/v agreement with the oracle: on the map ROI and on random colours.
    g = C.map_geometry(w, h)
    roi_rgb = frame[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w, 2::-1]
    rand_rgb = np.random.default_rng(0).integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    hsv_agree = {}
    for name, rgb in (("map_roi", np.ascontiguousarray(roi_rgb)), ("random", rand_rgb)):
        want = pm.rgb_to_hsv_u8(rgb)
        got = jax.device_get(jhsv.rgb_to_hsv_u8(jnp.asarray(rgb)))
        hsv_agree[name] = {c: float((a == b).mean()) for c, a, b in zip("hsv", got, want)}

    # Device glyph classification vs float64 on the same device features.
    tpl = sd.device_templates()
    text = jnp.asarray(ocr_img < sd.OCR_BINARY_THRESHOLD)
    feats, oks, chars, scores = jax.device_get(
        jax.jit(sd.glyph_reads)(text, jnp.asarray(tpl))
    )
    oks = oks.astype(bool)
    check(bool(oks.any()), "no glyph read on the smoke frame")
    s64 = feats[oks].astype(np.float64) @ tpl.astype(np.float64).T
    check(bool((chars[oks] == s64.argmax(axis=1)).all()),
          f"glyph chars {chars[oks]} vs float64 {s64.argmax(axis=1)}")
    score_err = float(np.abs(scores[oks] - s64.max(axis=1)).max())
    check(score_err <= SCORE_TOL, f"glyph scores differ from float64 by {score_err}")
    rec = np.asarray(jax.jit(sd.scales_records)(
        text, jnp.asarray(scales_img != 0), jnp.asarray(tpl)
    ))
    words = rec[sd.HDR_I16:].reshape(sd.N_WORDS, sd.WORD_I16)
    rec_chars = np.concatenate([r[10 : 10 + r[0]] for r in words if r[0] > 0])
    rec_scores = np.concatenate([r[10 + sd.MAX_WG : 10 + sd.MAX_WG + r[0]] for r in words if r[0] > 0])
    check(rec_chars.tolist() == chars[oks].tolist(),
          f"record chars {rec_chars} vs glyph chars {chars[oks]}")
    check(bool((np.abs(rec_scores - s64.max(axis=1) * 1000.0) <= 1.0).all()),
          f"record scores {rec_scores} vs float64 {s64.max(axis=1)}")
    text_read = "".join(sd.CHARS[c % len(sd.CHARS)] for c in rec_chars)
    check(text_read == "300m", f"device read {text_read!r}")

    result = {
        "res": f"{w}x{h}", "marker_mask_agreement": mask_agree,
        "hsv_agreement": hsv_agree, "glyphs": int(oks.sum()), "text": text_read,
        "max_score_err_vs_f64": score_err,
    }
    if memory_analysis:
        result["fused_memory_analysis"] = _fused_memory_analysis(frame)
    return result


def _fused_memory_analysis(frame: np.ndarray) -> dict:
    """compiled.memory_analysis() of the production fused-pass bucket: the
    flags a live session with SmhOcrEngine dispatches (device scales
    records, sparse mask transport, no u8 mask output)."""
    from smh_tpu.ops import pipeline as ops_pipeline
    from smh_tpu.vision.tpu_backend import ROI_CHANNELS, TpuBackend

    be = TpuBackend()
    be.scales_binary_ok = be.scales_image_derived = be.scales_device_ok = True
    be.load_frame(frame)
    check(be.crop_to_map(True) is not None, "device sleeps on the smoke frame")
    g = be.geom
    with_ocr, with_quiet, gray, crop_h, crop_w, inline, band, sparse = be._dispatch_flags
    compiled = ops_pipeline._analyze_packed_flat.lower(
        be.rois_dev, map_h=g.map_h, map_w=g.map_w, btn_h=g.btn_h, btn_w=g.btn_w,
        grayscale=gray, with_ocr=with_ocr, with_quiet=with_quiet, crop_h=crop_h,
        crop_w=crop_w, scales_inline=inline,
        with_mask_output=be.lsd_engine != "native",
        channels=ROI_CHANNELS, scales_band=band, sparse_budget=sparse,
    ).compile()
    ma = compiled.memory_analysis()
    return {k: getattr(ma, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
        "alias_size_in_bytes", "generated_code_size_in_bytes",
    ) if hasattr(ma, k)}


def native_built() -> dict:
    """The C++ host module must build from source here."""
    from smh_tpu import native

    existed = native._SO.exists()
    check(native.available(), "native module failed to build")
    check(native._SO.stat().st_mtime >= native._SRC.stat().st_mtime,
          "native library is older than its source")
    return {"native": True, "built_now": not existed}


def main() -> int:
    t_start = time.perf_counter()
    try:
        card = device_info.card()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    try:
        dev = device_info.require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    print(f"card: {card}", flush=True)
    try:
        import cv2  # noqa: F401

        cv2_found = True
    except ImportError:
        cv2_found = False
    emit("setup", card=card, probe=dev, cv2=cv2_found, **native_built())
    workers = max(1, min(8, (os.cpu_count() or 2) // 2))

    w4, h4 = RES["4k"]
    t = time.perf_counter()
    emit("a_worker", card=card, **phase_worker(w4, h4, 8, workers), wall_s=time.perf_counter() - t)

    import jax

    dev_now = device_info.describe()
    check(dev_now["platform"] == "gpu", f"in-process platform {dev_now}")
    for res in ("4k", "1080p"):
        t = time.perf_counter()
        emit("b_live", card=card, **phase_live(*RES[res], 4, workers), wall_s=time.perf_counter() - t)
    t = time.perf_counter()
    video = testing.make_video_frames(w4, h4, 48)
    emit("c_batch", card=card, **phase_batch(video, 16, workers), wall_s=time.perf_counter() - t)
    t = time.perf_counter()
    emit("d_device_march", card=card, **phase_device_march(w4, h4), wall_s=time.perf_counter() - t)
    t = time.perf_counter()
    emit("e_fused_parity", card=card, **phase_fused_parity(w4, h4), wall_s=time.perf_counter() - t)
    emit("done", card=card, total_s=time.perf_counter() - t_start,
         peak_bytes_in_use=jax.devices()[0].memory_stats().get("peak_bytes_in_use"))
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
