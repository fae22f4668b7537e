"""CPU-mode smokes for bench.py's measurement plumbing: the driver runs
`python bench.py` unattended at round end, so the helpers that feed the
JSON-of-record get exercised here (on the forced-CPU 8-device conftest
environment) rather than discovered broken on the recording run.

The numbers themselves are meaningless on CPU — only shapes, fields and
invariants are asserted.
"""

from __future__ import annotations

import sys

import pytest

sys.path.insert(0, ".")

import bench  # noqa: E402


pytestmark = pytest.mark.slow


def test_make_bench_frames_are_distinct_and_bgra():
    frames = bench.make_bench_frames(960, 540)
    assert len(frames) >= 2
    for f in frames:
        assert f.shape == (540, 960, 4) and f.dtype.kind == "u"
    assert any((frames[0] != f).any() for f in frames[1:])


def test_measure_corpus_live_fields():
    """Full mode folds a compact real-screenshot live-drag into the JSON of
    record: steady live p50 + transport counters + the map-switch cost.
    Shapes only on CPU; small resolution to bound jit time."""
    from tests.conftest import reference_samples_available

    if not reference_samples_available():
        pytest.skip("reference samples absent")
    state = bench.build_state()
    try:
        out = bench.measure_corpus_live(state, 960, 540, n_samples=1, steps=4)
    finally:
        state.close()
    assert out["corpus_live_p50_ms"] > 0
    assert out["map_switch_p50_ms"] > 0
    assert out["corpus_live_frames"] == 2  # steps - map switch - escalation
    assert out["corpus_live_h2d_bytes_per_frame"] > 0
    assert out["map_switch_full_uploads"] >= 1
    # The switch-frame attribution: per-stage waterfall + the re-upload's
    # size + expected transfer time at the probed H2D bandwidth.
    stages = out["map_switch_stage_p50_ms"]
    assert stages.get("load_frame", 0) > 0 and "entire_frame" in stages
    assert out["map_switch_h2d_bytes"] > 100_000  # full packed ROIs, not delta
    assert out["map_switch_link_ms_est"] > 0
    assert out["h2d_mb_per_s"] > 0


def test_measure_worker_decomposition_fields():
    """The worker metrics must carry the e2e AND its decomposition (shm
    submit half + worker-side pipeline half) — a small resolution keeps the
    child's warmup to seconds on CPU (960x540 is the worker-test shape;
    bench frames need the BRQ region to fit its rendered scale text)."""
    out = bench.measure_worker(960, 540, iters=3, stream_s=1.0)
    assert out["worker_e2e_p50_ms"] > 0
    assert 0 <= out["worker_submit_p50_ms"] <= out["worker_e2e_p50_ms"]
    assert out["worker_pipeline_p50_ms"] > 0
    assert out["worker_restarts"] == 0


def test_persistent_compilation_cache_is_actually_on():
    """The suite runs with the persistent compilation cache on, set through
    jax.config by smh_tpu.jax_cache."""
    import jax

    assert jax.config.jax_compilation_cache_dir, (
        "conftest must activate the persistent cache via jax_cache.enable"
    )
    assert float(jax.config.jax_persistent_cache_min_compile_time_secs) <= 0.5
