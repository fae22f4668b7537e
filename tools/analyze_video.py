"""Offline gameplay-recording analysis: video -> per-frame detections JSONL.

The batched counterpart of the live loop (VideoSource -> vision/batch.py):
decodes a recording, runs B frames per device dispatch, and prints one JSON
line per analyzed frame with markers / minimap / scale ratio. The
throughput-mode answer to the reference's live-only design.

Usage:
  python tools/analyze_video.py clip.mp4 [--batch 8] [--step 3] [--limit N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("video")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--step", type=int, default=1, help="analyze every Nth frame")
    ap.add_argument("--limit", type=int, default=0, help="stop after N analyzed frames")
    ap.add_argument("--ocr", choices=["auto", "none"], default="auto")
    args = ap.parse_args()

    from smh_tpu.ocr import tesseract
    from smh_tpu.squadex.capture import VideoSource
    from smh_tpu.vision.batch import BatchPipeline

    src = VideoSource(args.video, step=args.step)
    engine = tesseract.create_default_engine() if args.ocr == "auto" else None

    n = 0
    emitted = 0
    t0 = time.time()

    def emit(results):
        nonlocal emitted
        for r in results:
            out = {
                "frame": emitted,
                "sleeping": r.sleeping,
                "markers": [[[l.p0.x, l.p0.y], [l.p1.x, l.p1.y]] for l in r.markers],
                "meters_to_px_ratio": r.meters_to_px_ratio,
                "minimap": None
                if r.minimap_bounds is None
                else [r.minimap_bounds.left, r.minimap_bounds.top,
                      r.minimap_bounds.right, r.minimap_bounds.bottom],
            }
            print(json.dumps(out), flush=True)
            emitted += 1

    frames = src.iter_frames()
    try:
        first = next(frames)
    except StopIteration:
        src.close()
        print("no frames decoded", file=sys.stderr)
        return 1
    h, w = first.shape[:2]
    bp = BatchPipeline(w, h, batch=args.batch, ocr_engine=engine)

    def batches():
        """Decode into batch-sized groups. Runs on stream()'s submitter
        thread, so decode + pack + diff of batch N+1 overlap the collect
        (fetch + host stages) of batch N on the main thread."""
        nonlocal n
        pending = [first]
        n = 1
        for img in frames:
            if args.limit and n >= args.limit:
                break
            pending.append(img)
            n += 1
            if len(pending) == args.batch:
                yield pending
                pending = []
        if pending:
            yield pending

    try:
        for results in bp.stream(batches()):
            emit(results)
    finally:
        src.close()
        bp.close()
    dt = time.time() - t0
    print(f"analyzed {n} frames in {dt:.1f}s ({n/max(dt,1e-9):.1f} fps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
