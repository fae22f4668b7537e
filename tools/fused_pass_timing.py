"""Time the 4K fused-pass bucket on the device, with and without the minimap
quiet path.

The fused pass (ops/pipeline._analyze_packed_flat) is timed on a resident
4K upload with the flags a live SmhOcrEngine session dispatches (device
scales records, sparse mask transport). with_quiet=False is the bucket the
minimap cadence uses on frames that reuse cached bounds; the difference is
the quiet path's cost. Two numbers per bucket, medians over --reps:
  chained_ms   N dispatches back to back, one sync at the end, over N
  synced_ms    one dispatch + block_until_ready, per call
Prints one JSON line with the card's name and power limit.

Usage (on the GPU):
  python tools/fused_pass_timing.py [--reps 7] [--chain 50]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--chain", type=int, default=50)
    args = ap.parse_args()

    from smh_tpu import device_info

    card = device_info.card()
    device_info.require_gpu()

    import jax

    from smh_tpu.ops import pipeline as ops_pipeline
    from smh_tpu.vision.tpu_backend import ROI_CHANNELS, TpuBackend

    import chip_smoke

    frame = chip_smoke.smoke_frames(3840, 2160, 1)[0]
    be = TpuBackend()
    be.scales_binary_ok = be.scales_image_derived = be.scales_device_ok = True
    be.load_frame(frame)
    be.crop_to_map(True)
    g = be.geom
    with_ocr, _, gray, crop_h, crop_w, inline, band, sparse = be._dispatch_flags

    out = {"card": card, **device_info.describe(), "res": "3840x2160",
           "roi_bytes": int(be.rois_dev.size), "scales_inline": inline,
           "sparse_budget": sparse}
    for with_quiet in (True, False):
        kw = dict(map_h=g.map_h, map_w=g.map_w, btn_h=g.btn_h, btn_w=g.btn_w,
                  grayscale=gray, with_ocr=with_ocr, with_quiet=with_quiet,
                  crop_h=crop_h, crop_w=crop_w, scales_inline=inline,
                  with_mask_output=be.lsd_engine != "native",
                  channels=ROI_CHANNELS, scales_band=band, sparse_budget=sparse)

        def run():
            return ops_pipeline._analyze_packed_flat(be.rois_dev, **kw)["hostpack"]

        t0 = time.perf_counter()
        jax.block_until_ready(run())
        compile_s = time.perf_counter() - t0
        chained, synced = [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for _ in range(args.chain):
                r = run()
            jax.block_until_ready(r)
            chained.append((time.perf_counter() - t0) * 1e3 / args.chain)
            t0 = time.perf_counter()
            for _ in range(args.chain):
                jax.block_until_ready(run())
            synced.append((time.perf_counter() - t0) * 1e3 / args.chain)
        key = "quiet_on" if with_quiet else "quiet_off"
        out[key] = {"chained_ms": statistics.median(chained),
                    "synced_ms": statistics.median(synced),
                    "chained_ms_all": chained, "compile_s": compile_s}
    on, off = out["quiet_on"]["chained_ms"], out["quiet_off"]["chained_ms"]
    out["quiet_share_of_fused_pass"] = (on - off) / on
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
