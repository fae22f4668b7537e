"""Oracle-vs-device-backend parity: the automated cross-backend diff the
reference never had (SURVEY.md section 4 lists it as the gap to close).
Runs on the CPU platform in CI; the same code path runs on the GPU (chip_smoke.py, tests/test_chip.py)."""

import numpy as np
import pytest

from smh_tpu import consts as C, testing
from smh_tpu.geometry import Point
from smh_tpu.ops import lsd as ops_lsd
from smh_tpu.ops import pipeline as ops_pipeline
from smh_tpu.vision import pixmath as pm
from smh_tpu.vision.reference import ReferenceBackend, find_longest_line as oracle_march
from smh_tpu.vision.tpu_backend import TpuBackend

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.slow  # jit-compile heavy (see pyproject markers)


def rand_rgb(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def test_hsv_parity_random():
    # XLA lowers f32 division via reciprocal-multiply (1 ulp off IEEE in
    # ~0.5-2% of cases), so truncated h/s/v can flip by one at integer
    # boundaries. Luma (no division) must be exact; the thresholds below are
    # the measured agreement with headroom. Detection-level tests assert the
    # real contract: identical lines.
    from smh_tpu.ops import hsv as jhsv

    rgb = rand_rgb((256, 256, 3))
    h0, s0, v0 = pm.rgb_to_hsv_u8(rgb)
    h1, s1, v1 = jax.device_get(jhsv.rgb_to_hsv_u8(jnp.asarray(rgb)))
    assert (h0 == h1).mean() > 0.99
    assert (np.abs(h0.astype(int) - h1.astype(int)) <= 1).all()
    assert (s0 == s1).mean() > 0.98
    assert (v0 == v1).mean() > 0.96
    l0 = pm.luma8(rgb)
    l1 = np.asarray(jhsv.luma8(jnp.asarray(rgb)))
    assert (l0 == l1).all()


def test_marker_predicate_parity():
    from smh_tpu.ops import hsv as jhsv

    rgb = rand_rgb((512, 512, 3), seed=1)
    m0 = pm.is_any_map_marker_color(rgb)
    m1 = np.asarray(jhsv.is_any_map_marker_color(jnp.asarray(rgb)))
    # Threshold flips from division ulps tolerated at <=0.01% of pixels.
    assert (m0 == m1).mean() > 0.9999


def test_fused_pass_parity_synthetic():
    frame = testing.make_frame(
        1280,
        720,
        marker_lines=[((100, 100), (420, 300)), ((50, 400), (500, 380))],
        scale_bars=[(60, 200, 120, 1)],
    )
    ref = ReferenceBackend()
    ref.load_frame(frame)
    ui_ref, bbox_ref = ref.crop_to_map(grayscale=True)
    ref.isolate_map_markers()
    ref.mask_marker_lines()
    ocr_ref = ref.ocr_preprocess()
    scales_ref = ref.find_scales_preprocess(0)

    tpu = TpuBackend()
    tpu.load_frame(frame)
    out = tpu.crop_to_map(grayscale=True)
    assert out is not None
    ui_tpu, bbox_tpu = out
    if callable(ui_tpu):  # lazy display-image fetcher
        ui_tpu = ui_tpu()
    tpu.mask_marker_lines()
    ocr_tpu = tpu.ocr_preprocess()
    scales_tpu = tpu.find_scales_preprocess(0)

    assert bbox_ref == bbox_tpu
    # luma and the integer OCR masks have no division -> exact parity.
    assert (ui_ref == ui_tpu).all()
    assert (ocr_ref == ocr_tpu).all()
    assert (scales_ref == scales_tpu).all()
    # the marker mask can flip at HSV integer boundaries (division ulps).
    assert (ref.lsd_image == tpu._full_mask_host()).mean() > 0.999


def test_red_gate_parity():
    frame_on = testing.make_frame(1280, 720, with_button=True)
    frame_off = testing.make_frame(1280, 720, with_button=False)
    assert ops_pipeline.red_gate(jax.device_put(frame_on)) >= 0.65
    assert ops_pipeline.red_gate(jax.device_put(frame_off)) < 0.65


def test_march_parity_on_synthetic_masks():
    from smh_tpu.utils.plot import plot_line

    rng = np.random.default_rng(7)
    mask = np.zeros((300, 400), dtype=np.uint8)
    plot_line(mask, 30, 40, 350, 250, 255)
    plot_line(mask, 30, 40, 200, 45, 255)
    mask = pm.dilate_l1_radius1(mask)
    # noise specks
    ys = rng.integers(0, 300, 50)
    xs = rng.integers(0, 400, 50)
    mask[ys, xs] = 255

    mask_dev = jax.device_put(mask)
    for pt in [Point(30.0, 40.0), Point(100.0, 80.0), Point(350.0, 250.0)]:
        line_o, len_o = oracle_march(mask, pt, 15.0)
        line_t, len_t = ops_lsd.find_longest_line(mask_dev, pt, 15.0)
        # Endpoints agree to sub-pixel; lengths to float noise.
        assert abs(line_o.p1.x - line_t.p1.x) <= 1.5, (pt, line_o, line_t)
        assert abs(line_o.p1.y - line_t.p1.y) <= 1.5, (pt, line_o, line_t)
        assert abs(len_o - len_t) <= max(4.0, 0.01 * max(len_o, 1.0))


def test_full_detection_parity_synthetic():
    expected = [((100, 100), (420, 300)), ((560, 50), (570, 420))]
    frame = testing.make_frame(1280, 720, marker_lines=expected)

    ref = ReferenceBackend()
    ref.load_frame(frame)
    assert ref.crop_to_map(grayscale=True) is not None
    ref.isolate_map_markers()
    ref.mask_marker_lines()
    lines_ref = ref.find_marker_lines(C.LSD_MAX_GAP)

    tpu = TpuBackend()
    tpu.load_frame(frame)
    assert tpu.crop_to_map(grayscale=True) is not None
    lines_tpu = tpu.find_marker_lines(C.LSD_MAX_GAP)

    assert len(lines_ref) == len(lines_tpu) == 2
    for lr, lt in zip(lines_ref, lines_tpu):
        assert abs(lr.p0.x - lt.p0.x) <= 1.5 and abs(lr.p0.y - lt.p0.y) <= 1.5
        assert abs(lr.p1.x - lt.p1.x) <= 1.5 and abs(lr.p1.y - lt.p1.y) <= 1.5
