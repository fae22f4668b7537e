"""A/B a frame through the numpy oracle and the device backend, diff everything.

The operational counterpart of the reference's live CPU/GPU toggle
(src/vision/hardware.rs:14-45) — but as an automated diff instead of an
eyeball check. Usage:

    python tools/compare_backends.py <frame.png>
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__)
        return 2

    from smh_tpu.squadex.capture import load_frame_bgra
    from smh_tpu.vision.reference import ReferenceBackend
    from smh_tpu.vision.tpu_backend import TpuBackend

    frame = load_frame_bgra(sys.argv[1])

    def run(be):
        be.load_frame(frame)
        cropped = be.crop_to_map(grayscale=True)
        if cropped is None:
            return None
        ui, bbox = cropped
        if callable(ui):
            ui = ui()
        be.isolate_map_markers()
        be.mask_marker_lines()
        lines = be.find_marker_lines(15)
        ocr = be.ocr_preprocess()
        scales = be.find_scales_preprocess(0)
        mask = be.lsd_image if hasattr(be, "lsd_image") else be._lsd_mask_host
        return dict(ui=ui, bbox=bbox, lines=lines, ocr=ocr, scales=scales, mask=mask)

    ref = run(ReferenceBackend())
    tpu = run(TpuBackend())

    if ref is None or tpu is None:
        print(f"sleeping: oracle={ref is None} tpu={tpu is None}")
        return 0 if (ref is None) == (tpu is None) else 1

    ok = True

    def pct(a, b):
        return float((a == b).mean()) * 100.0

    print(f"map bbox: oracle={ref['bbox']} tpu={tpu['bbox']} "
          f"{'OK' if ref['bbox'] == tpu['bbox'] else 'MISMATCH'}")
    print(f"ui map agreement:     {pct(ref['ui'], tpu['ui']):8.4f}%")
    print(f"lsd mask agreement:   {pct(ref['mask'], tpu['mask']):8.4f}%")
    print(f"ocr image agreement:  {pct(ref['ocr'], tpu['ocr']):8.4f}%")
    print(f"scales agreement:     {pct(ref['scales'] != 0, tpu['scales'] != 0):8.4f}%")

    print(f"lines: oracle={len(ref['lines'])} tpu={len(tpu['lines'])}")
    if len(ref["lines"]) != len(tpu["lines"]):
        ok = False
    for i, (a, b) in enumerate(zip(ref["lines"], tpu["lines"])):
        d0 = max(abs(a.p0.x - b.p0.x), abs(a.p0.y - b.p0.y))
        d1 = max(abs(a.p1.x - b.p1.x), abs(a.p1.y - b.p1.y))
        status = "OK" if max(d0, d1) <= 1.5 else "MISMATCH"
        if status != "OK":
            ok = False
        print(f"  line {i}: start d={d0:.3f} end d={d1:.3f}  {status}")
        print(f"    oracle ({a.p0.x:.1f},{a.p0.y:.1f})->({a.p1.x:.1f},{a.p1.y:.1f})")
        print(f"    tpu    ({b.p0.x:.1f},{b.p0.y:.1f})->({b.p1.x:.1f},{b.p1.y:.1f})")

    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
