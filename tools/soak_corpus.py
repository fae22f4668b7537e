# Full golden corpus through the device backend: crash soak + detection
# audit vs goldens. Default platform: forced CPU (safe anywhere). Pass
# --device to run on the accelerator (first run compiles several resolution
# buckets).
import sys, json, pathlib, os
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import jax
if "--device" not in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
from smh_tpu.squadex.capture import load_frame_bgra
from smh_tpu.vision.tpu_backend import TpuBackend

goldens = json.loads((ROOT / "tests" / "goldens" / "detections.json").read_text())
samples = pathlib.Path("/root/reference/vision-common/samples")
bad = 0
be = TpuBackend()
for name, g in sorted(goldens.items()):
    frame = load_frame_bgra(str(samples / name))
    be.load_frame(frame)
    c = be.crop_to_map(True)
    if g["sleeping"]:
        status = "OK" if c is None else "MISMATCH(sleep)"
        if c is not None: bad += 1
        print(f"{name}: sleeping {status}")
        continue
    if c is None:
        print(f"{name}: MISMATCH (device sleeping, golden not)"); bad += 1; continue
    lines = be.find_marker_lines(15)
    exp = g["lines"]
    ok = len(lines) == len(exp) and all(
        abs(l.p1.x - e[2]) <= 1.5 and abs(l.p1.y - e[3]) <= 1.5 for l, e in zip(lines, exp)
    )
    if not ok: bad += 1
    print(f"{name}: {len(lines)}/{len(exp)} lines {'OK' if ok else 'MISMATCH'}")
print("TOTAL MISMATCHES:", bad)
