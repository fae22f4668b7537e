"""A/B a batch-path env knob in ONE process, interleaved.

Host and device speed drift between processes (clocks, neighbours, power
state), so two separate probe processes cannot attribute a per-frame delta
to a code change. This runs
measure_batched alternating an SMH_* knob A/B/A/B within one process
(shared jit cache, same phase window) and prints per-round and pooled
medians. Default knob: SMH_BATCH_BARRIER ''(lazy) vs 'eager'.

Usage:
  python tools/ab_batch_barrier.py [rounds] [batches] [KNOB=a,b] [WxH] [B]
e.g.
  python tools/ab_batch_barrier.py 3 6 SMH_BATCH_ROLL=1,0 3840x2160 8
"""

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def main() -> None:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    knob, _, vals = (
        sys.argv[3] if len(sys.argv) > 3 else "SMH_BATCH_BARRIER=,eager"
    ).partition("=")
    a_val, b_val = vals.split(",")
    w, h = (
        (int(v) for v in sys.argv[4].split("x")) if len(sys.argv) > 4 else (1920, 1080)
    )
    batch = int(sys.argv[5]) if len(sys.argv) > 5 else 16
    out: dict = {f"a({a_val})_ms": [], f"b({b_val})_ms": []}
    for r in range(rounds):
        # ABBA order: speed drifts WITHIN a round too, so a
        # fixed A-then-B order biases A toward whichever phase each round
        # starts in; alternating cancels it to first order.
        pair = [(a_val, f"a({a_val})_ms"), (b_val, f"b({b_val})_ms")]
        if r % 2:
            pair.reverse()
        for val, key in pair:
            b = batch
            if knob == "BATCH":  # pseudo-knob: A/B the batch size itself
                b = int(val)
            elif val:
                os.environ[knob] = val
            else:
                os.environ.pop(knob, None)
            ms, stats = bench.measure_batched(w, h, iters, batch=b)
            out[key].append(round(ms, 2))
            print(
                f"round {r} {knob}={val!r}: {ms:.2f} ms/frame  "
                f"poke={stats.get('t_poke_ms', 0):.0f}ms "
                f"pack={stats.get('t_pack_ms', 0):.0f}ms "
                f"fetch={stats.get('t_fetch_ms', 0):.0f}ms "
                f"host={stats.get('t_host_ms', 0):.0f}ms "
                f"lat={stats.get('lat_ms')}",
                file=sys.stderr,
                flush=True,
            )
    for key in list(out):
        if isinstance(out[key], list) and out[key]:
            out[key.replace("_ms", "_pooled_ms")] = round(
                statistics.median(out[key]), 2
            )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
