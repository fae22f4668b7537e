"""Generate golden detection snapshots from the numpy oracle over the
reference sample corpus (read-only at /root/reference/vision-common/samples).

The goldens pin the oracle's behaviour (regression protection) and serve as
the target the device backend is diffed against. Regenerate with:

    python tools/gen_goldens.py
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from smh_tpu.squadex.capture import load_frame_bgra  # noqa: E402
from smh_tpu.vision import find_minimap as fm  # noqa: E402
from smh_tpu.vision.reference import ReferenceBackend  # noqa: E402

SAMPLES = pathlib.Path("/root/reference/vision-common/samples")
OUT = pathlib.Path(__file__).resolve().parent.parent / "tests" / "goldens" / "detections.json"

# Every sample in the reference corpus except convolution.png (a 43x44
# kernel test image, not a game frame). a_point.png / line_angle.png are
# map-only crops without the close-deployment button: the red gate correctly
# reports them sleeping, and the goldens pin that.
FULL_FRAMES = [
    "a_point.png",
    "line_angle.png",
    "albasrah.png",
    "difficult.png",
    "full.jpg",
    "full_1024x768.png",
    "full_1280x1024.png",
    "full_1600x1024.png",
    "fullmap.jpg",
    "fullmapgreen.jpg",
    "fullmapsnow.jpg",
    "glorious.png",
    "in_mortar.png",
    "lol.png",
    "point.png",
    "point2.png",
    "point_far.png",
    "point_intersect.png",
    "point_opposite_h.png",
    "point_opposite_v.png",
    "points.png",
    "points_intersect.png",
    "snowpoints.png",
    "tinyscales.png",
    "vlcsnap-2022-05-11-06h03m39s483.png",
    "whiteout.png",
]


def main() -> None:
    goldens = {}
    for name in FULL_FRAMES:
        path = SAMPLES / name
        if not path.exists():
            print(f"skip {name} (missing)")
            continue
        t0 = time.time()
        frame = load_frame_bgra(str(path))
        be = ReferenceBackend()
        be.load_frame(frame)
        cropped = be.crop_to_map(grayscale=True)
        entry: dict = {"frame": list(frame.shape[:2])}
        if cropped is None:
            entry["sleeping"] = True
        else:
            _, (x, y, w, h) = cropped
            entry["sleeping"] = False
            entry["map_bbox"] = [x, y, w, h]
            be.isolate_map_markers()
            be.mask_marker_lines()
            entry["mask_px"] = int((be.lsd_image == 255).sum())
            lines = be.find_marker_lines(15)
            entry["lines"] = [
                [round(l.p0.x, 3), round(l.p0.y, 3), round(l.p1.x, 3), round(l.p1.y, 3)]
                for l in lines
            ]
            mb = fm.find_minimap(frame[y : y + h, x : x + w])
            entry["minimap"] = [mb.left, mb.top, mb.right, mb.bottom] if mb else None
        goldens[name] = entry
        print(f"{name}: {entry.get('lines', 'sleeping')} ({time.time()-t0:.1f}s)")

    OUT.write_text(json.dumps(goldens, indent=1, sort_keys=True))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
