"""Persistent worker process: shm frame ring -> pipeline -> socket results.

Covers the co-located deployment shape (smh_tpu/worker.py; the reference's
single-process loop is src/vision/mod.rs:243-315 — this rebuild can split
capture client and pipeline worker so one process owns the device, and that
process recycles itself past an upload budget, docs/DESIGN.md §3)."""

import os
import threading
import time

import numpy as np
import pytest

from smh_tpu import testing
from smh_tpu.worker import FrameRing, WorkerClient

W, H = 960, 540  # small: the worker compiles its jit bucket at startup

pytestmark = pytest.mark.slow


class Collector:
    def __init__(self) -> None:
        self.results: dict[int, dict] = {}
        self.cond = threading.Condition()

    def __call__(self, msg: dict) -> None:
        with self.cond:
            self.results[msg["seq"]] = msg
            self.cond.notify_all()

    def wait_for(self, seq: int, timeout: float = 240.0) -> dict:
        deadline = time.monotonic() + timeout
        with self.cond:
            while seq not in self.results:
                left = deadline - time.monotonic()
                assert left > 0, f"no result for seq {seq}"
                self.cond.wait(min(left, 1.0))
            return self.results[seq]


def make_frames(n: int = 3) -> list[np.ndarray]:
    return [
        testing.make_frame(
            W, H, marker_lines=[((40 + 5 * i, 60), (300 + 5 * i, 200))]
        )
        for i in range(n)
    ]


def submit_until_accepted(wc: WorkerClient, img, timeout: float = 240.0):
    """submit() drops frames while the worker is (re)starting or the ring is
    full — retry until one is accepted, like a capture loop would."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        seq = wc.submit(img)
        if seq is not None:
            return seq
        time.sleep(0.2)
    raise AssertionError("worker never accepted a frame")


def test_worker_end_to_end():
    col = Collector()
    wc = WorkerClient(W, H, col)
    try:
        assert wc.wait_ready_progress(idle_timeout=120, max_s=240)
        # The child streamed warmup progress and stamped the ready event
        # with its warmup wall time (the bench records it).
        assert wc.last_warming is not None and wc.last_warming["total"] == 2
        assert wc.ready_info is not None and wc.ready_info["warmup_s"] >= 0
        frames = make_frames(3)
        seqs = []
        for img in frames:
            seqs.append(submit_until_accepted(wc, img))
        for i, seq in enumerate(seqs):
            msg = col.wait_for(seq)
            assert msg["sleeping"] is False
            assert len(msg["markers"]) == 1
            x0, y0, x1, y1 = msg["markers"][0]
            # marker_lines are in map-ROI coords; worker reports the same
            assert abs(x0 - (40 + 5 * i)) <= 3 and abs(y0 - 60) <= 3
            assert msg["ms"] > 0
        # A sleeping frame (deployment map closed: no red button) must come
        # back sleeping, not crash the ring/pipeline.
        sleeper = testing.make_frame(W, H, with_button=False)
        seq = submit_until_accepted(wc, sleeper)
        msg = col.wait_for(seq)
        assert msg["sleeping"] is True and "markers" not in msg
    finally:
        wc.close()


def test_worker_recycles_and_recovers():
    """A tiny upload budget forces the recycle path: the worker reports
    `recycling`, exits, the supervisor restarts it, and results keep
    flowing — the retention bound costs availability, not correctness."""
    col = Collector()
    wc = WorkerClient(W, H, col, env={"SMH_WORKER_RECYCLE_MB": "0.000001"})
    try:
        assert wc.wait_ready(timeout=240)
        img = make_frames(1)[0]
        first = submit_until_accepted(wc, img)
        col.wait_for(first)
        # The first processed frame overflows the budget: worker recycles.
        deadline = time.monotonic() + 240
        while wc.restarts == 0 and time.monotonic() < deadline:
            time.sleep(0.2)
        assert wc.restarts >= 1
        # After the restart, the fresh worker serves frames again.
        again = submit_until_accepted(wc, img)
        msg = col.wait_for(again)
        assert msg["sleeping"] is False and len(msg["markers"]) == 1
    finally:
        wc.close()


def test_worker_map_slot():
    """set_maps(True) makes the worker publish the RGBA ui map through the
    shm map slot whenever its checksum changes; the client callback gets a
    map-sized array (the app's web layer pushes it to viewers)."""
    col = Collector()
    maps = []
    ev = threading.Event()

    def on_map(rgba, seq):
        maps.append((rgba, seq))
        ev.set()

    wc = WorkerClient(W, H, col, on_map=on_map)
    try:
        assert wc.wait_ready(timeout=240)
        wc.set_maps(True)
        img = make_frames(1)[0]
        seq = submit_until_accepted(wc, img)
        col.wait_for(seq)
        assert ev.wait(timeout=60), "no map published"
        rgba, mseq = maps[0]
        from smh_tpu import consts as C

        g = C.map_geometry(W, H)
        assert rgba.shape == (g.map_h, g.map_w, 4)
        assert rgba[..., 3].min() == 255  # opaque RGBA, a real ui image
    finally:
        wc.close()


def test_dead_worker_diagnosed_fast():
    """A child that dies on startup must fail wait_ready_progress in
    ~seconds (not a flat deadline) and diagnose() must name the failure:
    exit code + the child's stderr tail (round 4's bench burned 900 s to
    report 'worker never became ready' with zero diagnostics)."""
    col = Collector()
    t0 = time.monotonic()
    # PYTHONHOME=/nonexistent kills the interpreter during startup (a bogus
    # JAX_PLATFORMS is NOT enough — the delegate falls back to the numpy
    # backend and the worker comes up healthy, by design).
    wc = WorkerClient(
        W, H, col, env={"PYTHONHOME": "/nonexistent"}, max_restarts=0
    )
    try:
        assert not wc.wait_ready_progress(idle_timeout=6, max_s=60)
        assert time.monotonic() - t0 < 55
        d = wc.diagnose()
        assert "ready=False" in d
        assert "exit_code=" in d and "exit_code=None" not in d
        assert "stderr:" in d  # the traceback tail is surfaced
    finally:
        wc.close()


def test_frame_ring_mailbox_semantics():
    """try_publish drops when all slots are busy; release frees them."""
    ring = FrameRing("smh-test-ring-%d" % os.getpid(), 64, 48, create=True)
    try:
        img = np.zeros((48, 64, 4), dtype=np.uint8)
        slots = [ring.try_publish(img, seq=i + 1, dpi=96) for i in range(4)]
        assert all(s is not None for s in slots)
        assert ring.try_publish(img, seq=99, dpi=96) is None  # full: drop
        view, seq, dpi = ring.view(slots[0])
        assert (seq, dpi) == (1, 96) and view.shape == (48, 64, 4)
        ring.release(slots[0])
        assert ring.try_publish(img, seq=100, dpi=96) is not None
    finally:
        ring.close(unlink=True)
