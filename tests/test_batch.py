import time

import numpy as np
import pytest

from smh_tpu import testing
from smh_tpu.ocr import FakeOcrEngine, OcrResult
from smh_tpu.vision.batch import BatchPipeline

pytestmark = pytest.mark.slow  # jit-compile heavy (see pyproject markers)


def test_batch_matches_single():
    frames = [
        testing.make_frame(1280, 720, marker_lines=[((100, 100), (420, 300))]),
        testing.make_frame(1280, 720, marker_lines=[((50, 400), (500, 380))]),
        testing.make_frame(1280, 720, with_button=False),  # sleeping
    ]
    bp = BatchPipeline(1280, 720, batch=4, ocr_engine=None)
    results = bp.process(frames)
    assert len(results) == 3
    assert not results[0].sleeping and len(results[0].markers) == 1
    assert not results[1].sleeping and len(results[1].markers) == 1
    assert results[2].sleeping

    # Same detections as the per-frame device backend.
    from smh_tpu.vision.tpu_backend import TpuBackend

    be = TpuBackend()
    be.load_frame(frames[0])
    assert be.crop_to_map(True) is not None
    single = be.find_marker_lines(15)
    assert len(single) == len(results[0].markers)
    for a, b in zip(single, results[0].markers):
        assert abs(a.p1.x - b.p1.x) < 1e-3 and abs(a.p1.y - b.p1.y) < 1e-3


def test_batch_delta_chain_matches_full():
    """Video-style sequence through the cross-batch delta chain == the same
    sequence through full uploads, frame for frame (the scan scatter
    reconstructs each frame's exact bytes)."""
    seq = [
        testing.make_frame(
            1280, 720,
            marker_lines=[((100 + 6 * i, 100 + 2 * i), (420 + 6 * i, 300))],
            scale_bars=[(60, 200, 120, 1)],
        )
        for i in range(10)
    ]

    def run(mode):
        bp = BatchPipeline(1280, 720, batch=4, ocr_engine=None)
        bp.delta_mode = mode
        results = []
        for s in range(0, len(seq), 4):
            results.extend(bp.process(seq[s : s + 4]))
        stats = dict(bp.stats)
        bp.close()
        return results, stats

    full, fstats = run("off")
    delta, dstats = run("on")
    assert fstats["delta_batches"] == 0
    assert dstats["delta_batches"] == 2  # batch 0 seeds, batches 1-2 ride deltas
    assert dstats["h2d_bytes"] < fstats["h2d_bytes"] / 2
    for i, (a, b) in enumerate(zip(full, delta)):
        assert a.sleeping == b.sleeping, f"frame {i}"
        assert [
            ((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in a.markers
        ] == [((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in b.markers], f"frame {i}"
        assert a.minimap_bounds == b.minimap_bounds, f"frame {i}"


def test_batch_delta_partial_batch_keeps_chain_consistent():
    """A short batch pads with zero-change repeats of its last frame; the
    next batch must still diff against the right chain tail."""
    seq = [
        testing.make_frame(1280, 720, marker_lines=[((100 + 8 * i, 100), (420, 300))])
        for i in range(5)
    ]
    bp = BatchPipeline(1280, 720, batch=4, ocr_engine=None)
    bp.delta_mode = "on"
    r1 = bp.process(seq[:3])  # partial batch seeds the chain
    r2 = bp.process(seq[3:])  # delta batch, head diffs vs seq[2]
    bp.close()

    bp_full = BatchPipeline(1280, 720, batch=4, ocr_engine=None)
    bp_full.delta_mode = "off"
    f1 = bp_full.process(seq[:3])
    f2 = bp_full.process(seq[3:])
    bp_full.close()

    for a, b in zip(r1 + r2, f1 + f2):
        assert [
            ((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in a.markers
        ] == [((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in b.markers]


def test_pipelined_batches_match_sequential():
    """submit(N+1) while N is in flight must produce the same results as
    sequential process() — incl. an intact cross-batch delta chain."""
    seq = [
        testing.make_frame(
            1280, 720,
            marker_lines=[((100 + 6 * i, 100 + 2 * i), (420 + 6 * i, 300))],
        )
        for i in range(12)
    ]

    bp = BatchPipeline(1280, 720, batch=4, ocr_engine=None)
    bp.delta_mode = "on"
    seq_results = []
    for s in range(0, 12, 4):
        seq_results.extend(bp.process(seq[s : s + 4]))
    bp.close()

    bp2 = BatchPipeline(1280, 720, batch=4, ocr_engine=None)
    bp2.delta_mode = "on"
    jobs = []
    piped = []
    for s in range(0, 12, 4):
        jobs.append(bp2.submit(seq[s : s + 4]))
        if len(jobs) > 1:
            piped.extend(bp2.collect(jobs.pop(0)))
    while jobs:
        piped.extend(bp2.collect(jobs.pop(0)))
    assert bp2.stats["delta_batches"] == 2
    bp2.close()

    for i, (a, b) in enumerate(zip(seq_results, piped)):
        assert a.sleeping == b.sleeping, i
        assert [
            ((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in a.markers
        ] == [((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in b.markers], i
        assert a.minimap_bounds == b.minimap_bounds, i


def test_batch_with_scales():
    ocr = FakeOcrEngine([OcrResult("300m", 91.0, 100, 180, 140, 195)])
    frames = [
        testing.make_frame(
            1280, 720, marker_lines=[((100, 100), (420, 300))], scale_bars=[(60, 200, 120, 1)]
        )
    ]
    bp = BatchPipeline(1280, 720, batch=2, ocr_engine=ocr)
    results = bp.process(frames)
    assert results[0].meters_to_px_ratio == pytest.approx(300 / 118)


def test_stream_matches_sequential_process():
    """stream() (submit worker thread ‖ collect caller thread) yields the
    same results, in order, as sequential process() over the same batches —
    including an intact cross-batch delta chain."""
    seq = [
        testing.make_frame(
            1280, 720,
            marker_lines=[((100 + 6 * i, 100 + 2 * i), (420 + 6 * i, 300))],
            scale_bars=[(60, 200, 120, 1)],
        )
        for i in range(12)
    ]
    batches = [seq[s : s + 4] for s in range(0, len(seq), 4)]

    bp_seq = BatchPipeline(1280, 720, batch=4, ocr_engine=None)
    expect = [bp_seq.process(b) for b in batches]
    seq_stats = dict(bp_seq.stats)
    bp_seq.close()

    bp_str = BatchPipeline(1280, 720, batch=4, ocr_engine=None)
    got = list(bp_str.stream(iter(batches)))
    str_stats = dict(bp_str.stats)
    bp_str.close()

    assert len(got) == len(expect)
    assert str_stats["delta_batches"] == seq_stats["delta_batches"]
    for bi, (ea, ga) in enumerate(zip(expect, got)):
        for fi, (a, b) in enumerate(zip(ea, ga)):
            assert a.sleeping == b.sleeping, f"batch {bi} frame {fi}"
            assert [
                ((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in a.markers
            ] == [
                ((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in b.markers
            ], f"batch {bi} frame {fi}"


def test_stream_propagates_source_errors():
    class Boom(Exception):
        pass

    def batches():
        yield [testing.make_frame(1280, 720, marker_lines=[((100, 100), (420, 300))])]
        raise Boom()

    bp = BatchPipeline(1280, 720, batch=4, ocr_engine=None)
    it = bp.stream(batches())
    first = next(it)
    assert len(first) == 1 and first[0].markers
    with pytest.raises(Boom):
        list(it)
    bp.close()


def test_stream_abandoned_early_collects_in_flight():
    """Breaking out of stream() must not leak the submitter thread or leave
    dispatched batches un-collected (materialization tracking stays exact:
    a later sequential submit sees a fully-fetched chain)."""
    import threading as _threading

    seq = [
        testing.make_frame(
            1280, 720,
            marker_lines=[((100 + 6 * i, 100 + 2 * i), (420 + 6 * i, 300))],
        )
        for i in range(16)
    ]
    batches = [seq[s : s + 4] for s in range(0, len(seq), 4)]
    bp = BatchPipeline(1280, 720, batch=4, ocr_engine=None)
    n_before = _threading.active_count()
    for rs in bp.stream(iter(batches), depth=2):
        assert rs[0].markers
        break  # abandon after the first yield
    # Submitter thread gone, every dispatched job collected.
    deadline = time.time() + 5
    while _threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert not any(t.name == "batch-submit" for t in _threading.enumerate())
    assert bp._fetched_seq == bp._seq, "in-flight job left un-fetched"
    # The pipeline stays usable sequentially afterwards.
    tail = bp.process(seq[-4:])
    assert all(r.markers for r in tail)
    bp.close()


def test_submit_barrier_gates_at_two_outstanding(monkeypatch):
    """The delta-chain barrier is LAZY: a delta submit waits for the
    previous program only when TWO dispatches are already unmaterialized
    (the per-frame driver's proven-safe chain depth — see batch.py
    submit()); SMH_BATCH_BARRIER=eager restores the round-4 poke on ANY
    outstanding program. Results must be identical either way."""
    from smh_tpu.vision import batch as batch_mod
    from smh_tpu.vision import tpu_backend

    seq = [
        testing.make_frame(
            1280, 720,
            marker_lines=[((100 + 6 * i, 100 + 2 * i), (420 + 6 * i, 300))],
        )
        for i in range(16)
    ]

    def run(env):
        if env:
            monkeypatch.setenv("SMH_BATCH_BARRIER", env)
        else:
            monkeypatch.delenv("SMH_BATCH_BARRIER", raising=False)
        waits = []
        real_wait = tpu_backend.wait_ready
        monkeypatch.setattr(
            tpu_backend, "wait_ready",
            lambda arr, **kw: (waits.append(1), real_wait(arr, **kw)),
        )
        bp = BatchPipeline(1280, 720, batch=4, ocr_engine=None)
        bp.delta_mode = "on"
        bp.process(seq[0:4])  # seed: full upload, fetched == seq
        jobs = [bp.submit(seq[s : s + 4]) for s in (4, 8, 12)]
        n_waits = len(waits)
        results = [r for j in jobs for r in bp.collect(j)]
        bp.close()
        assert all(not r.sleeping and r.markers for r in results)
        return n_waits, [
            ((l.p0.x, l.p0.y), (l.p1.x, l.p1.y))
            for r in results for l in r.markers
        ]

    lazy_waits, lazy_markers = run("")
    eager_waits, eager_markers = run("eager")
    # Lazy: submits at 0 and 1 outstanding pass free; only the third
    # (2 outstanding) pays the barrier. Eager: every delta submit with any
    # outstanding program pays it (submits 2 and 3 here).
    assert lazy_waits == 1, f"lazy barrier fired {lazy_waits}x, want 1"
    assert eager_waits == 2, f"eager barrier fired {eager_waits}x, want 2"
    assert lazy_markers == eager_markers
