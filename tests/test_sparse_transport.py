"""Sparse LSD mask transport (the production default).

The hostpack's dominant section used to be a windowed bit-mask crop
(~150 KB at 4K for a half-map window); the sparse transport ships the
compacted nonzero u32 words of the full bit plane instead (~5 KB for a
real marker mask) — see ops/pipeline._sparse_words and the backend's
_SPARSE_BUDGETS ladder. These tests pin the contract:

  * reconstruction is EXACT when the word count fits the budget, so
    detections are bit-identical to the window/full-mask transports;
  * overflow (nz > budget) is a detected miss: the backend falls back to
    the device-resident full bit-mask (still exact) and escalates the rung;
  * repeated misses step the transport aside (window ladder takes over),
    with a later re-probe;
  * the batch pipeline rides the same sections.
"""

import numpy as np
import pytest

from smh_tpu import consts as C, testing
from smh_tpu.ops import pipeline as op
from smh_tpu.vision.reference import ReferenceBackend
from smh_tpu.vision.tpu_backend import _SP_RUNG_DEFAULT, _SPARSE_BUDGETS, TpuBackend

pytestmark = pytest.mark.slow  # jit-compile heavy (see pyproject markers)

W, H = 1920, 1080  # map mask > 16 KiB: sparse transport active


def lines_tuples(lines):
    return [((l.p0.x, l.p0.y), (l.p1.x, l.p1.y)) for l in lines]


def lines_round(lines, nd=1):
    # the native march and the numpy oracle differ in f32 ulps; transport
    # tests pin EXACT equality between same-engine backends and approximate
    # equality vs the oracle
    return [tuple(round(v, nd) for v in (l.p0.x, l.p0.y, l.p1.x, l.p1.y)) for l in lines]


def detect(be, frame):
    be.load_frame(frame)
    assert be.crop_to_map(True) is not None
    return be.find_marker_lines(C.LSD_MAX_GAP)


def oracle_lines(frame):
    ref = ReferenceBackend()
    ref.load_frame(frame)
    ref.crop_to_map(True)
    ref.isolate_map_markers()
    ref.mask_marker_lines()
    return ref.find_marker_lines(C.LSD_MAX_GAP)


def two_lines_frame(off=0):
    return testing.make_frame(
        W, H,
        marker_lines=[((120 + off, 150), (380 + off, 320)), ((600, 160), (700, 480))],
    )


# -- ops-level: pack <-> reconstruct roundtrip ---------------------------------


@pytest.mark.parametrize("shape", [(120, 77), (64, 256), (17, 9)])
def test_sparse_words_roundtrip_exact(shape):
    import jax.numpy as jnp

    h, w = shape
    rng = np.random.default_rng(7)
    mask = rng.random((h, w)) < 0.02
    bits = np.asarray(op.pack_bits(jnp.asarray(mask)))
    budget = 4096  # plenty
    nz, idx, dat = (np.asarray(x) for x in op._sparse_words(jnp.asarray(mask), budget))
    assert int(nz) <= budget
    rec = op.sparse_mask_host(int(nz), idx, dat, h, w)
    assert np.array_equal(rec, bits)


def test_sparse_words_overflow_reports_true_count():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    mask = rng.random((64, 256)) < 0.5  # dense: every word nonzero
    bits = np.asarray(op.pack_bits(jnp.asarray(mask)))
    nz, idx, dat = (np.asarray(x) for x in op._sparse_words(jnp.asarray(mask), 16))
    assert int(nz) > 16  # the TOTAL count, not the truncated one
    # the first 16 nonzero words are still delivered in order
    bpr4 = op.sparse_word_pad(bits.shape[1])
    padded = np.zeros((64, bpr4), np.uint8)
    padded[:, : bits.shape[1]] = bits
    words = padded.reshape(-1, 4).view(np.uint32).reshape(-1)
    expect_idx = np.flatnonzero(words)[:16]
    assert np.array_equal(idx, expect_idx)
    assert np.array_equal(dat, words[expect_idx])


def test_hostpack_layout_sparse_sections():
    lay = op.hostpack_layout(800, 600, sparse_budget=1024)
    assert "lsd_crop" not in lay
    assert lay["lsd_sp_idx"][1] == 4096 and lay["lsd_sp_dat"][1] == 4096
    assert lay["lsd_nz"][1] == 4
    # window layout unchanged when sparse is off
    lay2 = op.hostpack_layout(800, 600)
    assert "lsd_nz" not in lay2 and "lsd_crop" in lay2


# -- backend: parity, miss, hysteresis -----------------------------------------


def test_sparse_detections_match_oracle_and_window():
    frame = two_lines_frame()
    be = TpuBackend()
    got = lines_tuples(detect(be, frame))
    assert be._dispatch_flags[7] is not None  # sparse transport was active
    assert be.stats["lsd_sparse_misses"] == 0
    assert len(got) == 2

    import os

    os.environ["SMH_SPARSE"] = "0"
    try:
        be_win = TpuBackend()
        got_win = lines_tuples(detect(be_win, frame))
        assert be_win._dispatch_flags[7] is None
    finally:
        del os.environ["SMH_SPARSE"]
    assert got == got_win  # bit-identical across transports (same engine)
    got_r = [tuple(round(v, 1) for pair in t for v in pair) for t in got]
    assert got_r == lines_round(oracle_lines(frame))


def test_sparse_pack_is_small():
    be = TpuBackend()
    # production engine capabilities (smhocr): the scales ride the ~1.2 KB
    # device-record transport, so the pack is dominated by the mask section
    be.scales_binary_ok = True
    be.scales_image_derived = True
    be.scales_device_ok = True
    be.load_frame(two_lines_frame())
    assert be.crop_to_map(True) is not None
    pack_bytes = int(np.asarray(be._results["hostpack"]).size)
    g = be.geom
    full_mask = g.map_h * ((g.map_w + 7) // 8)
    # the whole pack (incl. scales sections) undercuts even a 1/4-map window
    assert pack_bytes < full_mask // 4


def test_sparse_miss_falls_back_exactly_and_escalates():
    frame = two_lines_frame()
    want = lines_tuples(detect(TpuBackend(), frame))  # fitting sparse run
    be = TpuBackend()
    be._sp_rung = 0  # 256 words < the ~600 this mask produces
    got = lines_tuples(detect(be, frame))
    assert be.stats["lsd_sparse_misses"] == 1
    assert got == want  # full-mask fallback is exact
    assert be._sp_rung > 0  # escalated for the next frame
    # next frame fits: no further miss
    got2 = lines_tuples(detect(be, two_lines_frame(off=4)))
    assert be.stats["lsd_sparse_misses"] == 1
    assert len(got2) == 2


def test_sparse_steps_aside_after_repeated_misses_then_reprobes():
    from smh_tpu.vision import tpu_backend as tb

    be = TpuBackend()
    be.load_frame(two_lines_frame())
    # Simulate a dense-content session: every frame overflows the cap.
    cap_rung = len(_SPARSE_BUDGETS) - 1
    for _ in range(tb._SP_OFF_AFTER):
        be._sp_rung = cap_rung
        be._adapt_sp_rung(nz=_SPARSE_BUDGETS[cap_rung] + 1, budget=_SPARSE_BUDGETS[cap_rung])
    assert be._sp_probation == 1
    # While stepped aside, _sparse_budget yields None (window ladder rules).
    for _ in range(tb._SHRINK_AFTER - 1):
        assert be._sparse_budget() is None
    # ... and the re-probe eventually re-enables it.
    assert be._sparse_budget() is not None
    assert be._sp_miss_streak == 0


def test_sparse_rung_never_leaves_the_ladder():
    # Regression: repeated top-rung misses used to push _sp_rung past the
    # ladder end; a later resolution change's clamp loop then indexed
    # _SPARSE_BUDGETS out of range and crashed dispatch.
    from smh_tpu.vision import tpu_backend as tb

    be = TpuBackend()
    top = len(_SPARSE_BUDGETS) - 1
    for _ in range(tb._SP_OFF_AFTER - 1):  # stay short of probation
        be._adapt_sp_rung(nz=_SPARSE_BUDGETS[top] * 2, budget=_SPARSE_BUDGETS[top])
        assert be._sp_rung <= top
    be.load_frame(testing.make_frame(W, H))  # smaller geometry re-clamps
    assert be._sparse_budget() is not None
    assert 0 <= be._sp_rung <= top


def test_sparse_rung_escalates_before_the_first_miss():
    # The 5/4 slack steps the rung up while the mask still FITS, so a
    # growing marker drag never pays the full-mask fallback at a boundary.
    be = TpuBackend()
    be._sp_rung = _SP_RUNG_DEFAULT
    budget = _SPARSE_BUDGETS[_SP_RUNG_DEFAULT]
    be._adapt_sp_rung(nz=budget - 10, budget=budget)  # within slack of the top
    assert be._sp_rung > _SP_RUNG_DEFAULT
    assert be.stats["lsd_sparse_misses"] == 0


def test_sparse_rung_shrinks_after_streak():
    from smh_tpu.vision import tpu_backend as tb

    be = TpuBackend()
    be._sp_rung = _SP_RUNG_DEFAULT + 2
    budget = _SPARSE_BUDGETS[be._sp_rung]
    for _ in range(tb._SHRINK_AFTER):
        be._adapt_sp_rung(nz=10, budget=budget)
    assert be._sp_rung == _SP_RUNG_DEFAULT + 1


# -- batch pipeline -------------------------------------------------------------


def test_batch_sparse_matches_window_mode():
    from smh_tpu.vision.batch import BatchPipeline

    frames = [
        testing.make_frame(W, H, marker_lines=[((100 + 6 * i, 100), (420, 300))])
        for i in range(4)
    ]
    bp = BatchPipeline(W, H, batch=4, ocr_engine=None)
    assert bp.sparse_budget is not None and bp.crop_h is None
    got = [lines_tuples(r.markers) for r in bp.process(frames)]

    import os

    os.environ["SMH_SPARSE"] = "0"
    try:
        bp_win = BatchPipeline(W, H, batch=4, ocr_engine=None)
        assert bp_win.sparse_budget is None and bp_win.crop_h is not None
        want = [lines_tuples(r.markers) for r in bp_win.process(frames)]
    finally:
        del os.environ["SMH_SPARSE"]
    assert got == want
    assert all(len(x) == 1 for x in got)
