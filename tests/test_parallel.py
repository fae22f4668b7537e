"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from smh_tpu import consts as C
from smh_tpu.parallel import spmd

pytestmark = pytest.mark.slow  # jit-compile heavy (see pyproject markers)


@pytest.fixture(scope="module")
def mesh8():
    devices = jax.devices("cpu")
    if len(devices) < 8:
        pytest.skip("needs 8 virtual devices")
    return spmd.make_mesh(devices[:8], sp=2)


def test_analyze_batch_sharded_matches_single(mesh8):
    h, w = 128, 160
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, size=(8, h, w, 4), dtype=np.uint8)

    out = spmd.analyze_batch(jax.numpy.asarray(frames), mesh8)
    jax.block_until_ready(out)

    # Compare one frame against the unsharded single-frame pass.
    from smh_tpu.ops import pipeline as ops_pipeline

    single = ops_pipeline.analyze_frame(jax.device_put(frames[3]))
    assert (np.asarray(out["ui"][3]) == np.asarray(single["ui"])).all()
    assert (np.asarray(out["lsd_mask"][3]) == np.asarray(single["lsd_mask"])).all()
    assert (np.asarray(out["ocr_img"][3]) == np.asarray(single["ocr_img"])).all()


def test_full_step_runs_on_mesh(mesh8):
    h, w = 128, 160
    g = C.map_geometry(w, h)
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, size=(8, h, w, 4), dtype=np.uint8)
    pts = np.tile(np.array([[g.map_w / 2, g.map_h / 2]], dtype=np.float32), (8, 1))

    out = spmd.full_step(jax.numpy.asarray(frames), jax.numpy.asarray(pts), mesh8)
    jax.block_until_ready(out)
    assert out["red_ratio"].shape == (8,)
    assert out["best_end"].shape == (8, 2)
    assert np.isfinite(np.asarray(out["best_length_sqr"])).all()


def test_graft_entry_single_chip():
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "_graft_entry", pathlib.Path(__file__).parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    ui, lsd_mask, ocr_img, scales_bits = out
    assert ui.ndim == 2  # grayscale luma plane
    assert lsd_mask.shape == ui.shape


def test_graft_entry_dryrun_from_dirty_jax_state():
    """Round-1 regression: the driver imports __graft_entry__ and calls
    dryrun_multichip in a process whose JAX backend is already initialized
    (with the wrong platform / device count). The dryrun must self-provision
    its own virtual CPU mesh in a subprocess and succeed regardless.

    Simulated here by initializing a 1-device CPU JAX in the caller before
    the call (a real driver had an accelerator platform; tests must not touch it)."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).parent.parent
    env = dict(os.environ)
    # Caller env: single CPU device, so an in-process 8-device mesh would be
    # impossible — only the self-provisioned subprocess can succeed.
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        f"import sys; sys.path.insert(0, {str(repo)!r})\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "assert len(jax.devices()) == 1  # dirty, unusable caller state\n"
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(8)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=repo,
        capture_output=True,
        text=True,
        timeout=1800,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert "dryrun_multichip OK" in proc.stdout


def test_batch_packed_sharded_matches_unsharded(mesh8):
    """The PRODUCTION packed dispatch (windowed crop + inline band sections)
    sharded over the dp axis must produce byte-identical hostpacks to the
    unsharded run — the multi-chip throughput mode is the same compiled
    program, just laid out over the mesh."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from smh_tpu import testing
    from smh_tpu.ops import pipeline as ops_pipeline
    from smh_tpu.vision.tpu_backend import _pack_rois_bgr

    w, h = 320, 200
    g = C.map_geometry(w, h)
    rois = []
    for i in range(8):
        f = testing.make_frame(w, h, marker_lines=[((10 + i, 10), (60 + i, 40))])
        m = f[g.map_y : g.map_y + g.map_h, g.map_x : g.map_x + g.map_w]
        b = f[g.btn_y : g.btn_y + g.btn_h, g.btn_x : g.btn_x + g.btn_w]
        rois.append(_pack_rois_bgr(m, b))
    rois = np.stack(rois)

    kwargs = dict(
        map_h=g.map_h, map_w=g.map_w, btn_h=g.btn_h, btn_w=g.btn_w,
        grayscale=True, with_ocr=True, channels=3,
    )
    plain = ops_pipeline._analyze_batch_packed(jnp.asarray(rois), **kwargs)
    sharded_in = jax.device_put(rois, NamedSharding(mesh8, P("dp")))
    sharded = ops_pipeline._analyze_batch_packed(sharded_in, **kwargs)

    assert (np.asarray(plain["hostpack"]) == np.asarray(sharded["hostpack"])).all()
    assert (np.asarray(plain["lsd_bits"]) == np.asarray(sharded["lsd_bits"])).all()


def test_march_sharded_values_match_single(mesh8):
    """The dp-sharded batched march must produce VALUE-identical ends and
    lengths to the unsharded single-frame march (round-2 verdict: shapes
    alone would pass a wrong-but-finite sharded march)."""
    from smh_tpu import testing
    from smh_tpu.ops import lsd as ops_lsd

    w, h = 320, 200
    g = C.map_geometry(w, h)
    masks = []
    pts = []
    for i in range(8):
        f = testing.make_frame(w, h, marker_lines=[((10 + i, 12), (100 + i, 64))])
        from smh_tpu.vision.reference import ReferenceBackend

        be = ReferenceBackend()
        be.load_frame(f)
        be.crop_to_map(True)
        be.isolate_map_markers()
        be.mask_marker_lines()
        masks.append(be.lsd_image)
        pts.append([55.0 + i, 38.0])
    masks = np.stack(masks)
    pts = np.asarray(pts, np.float32)

    ends, lengths = spmd.march_batch(jax.numpy.asarray(masks), jax.numpy.asarray(pts), mesh8)
    ends = np.asarray(ends)
    lengths = np.asarray(lengths)

    mh, mw = masks.shape[1:]
    max_k = ops_lsd._max_k(mh, mw)
    for i in range(8):
        e1, l1 = ops_lsd._march(
            jax.numpy.asarray(masks[i]), jax.numpy.asarray(pts[i]),
            h=mh, w=mw, max_gap=C.LSD_MAX_GAP, max_k=max_k,
        )
        assert (np.asarray(e1) == ends[i]).all()
        assert (np.asarray(l1) == lengths[i]).all()


def test_batch_pipeline_mesh_full_dag(mesh8):
    """The COMPLETE frame->markers+scales DAG (BatchPipeline: fused pass,
    windowed LSD, device scale records, minimap rect, host march) run over
    the mesh must produce detections equal to the single-device pipeline."""
    from smh_tpu.ocr.smhocr import SmhOcrEngine
    from smh_tpu.vision.batch import BatchPipeline
    from tests.test_smhocr import render_text_frame

    w, h = 1280, 720
    # frames differ (text size varies) so a sharding/indexing mistake cannot
    # hide behind a repeated frame; each carries marker + "300m" + scale bar
    frames = [render_text_frame("300m", size=20 + (i % 3)) for i in range(8)]

    single = BatchPipeline(w, h, batch=8, ocr_engine=SmhOcrEngine())
    meshp = BatchPipeline(w, h, batch=8, ocr_engine=SmhOcrEngine(), mesh=mesh8)
    r1 = single.process(frames)
    r2 = meshp.process(frames)
    single.close()
    meshp.close()

    assert meshp.stats["full_batches"] == 1 and meshp.stats["delta_batches"] == 0
    for a, b in zip(r1, r2):
        assert a.sleeping == b.sleeping
        assert [(l.p0, l.p1) for l in a.markers] == [(l.p0, l.p1) for l in b.markers]
        assert a.minimap_bounds == b.minimap_bounds
        assert a.meters_to_px_ratio == b.meters_to_px_ratio
    assert not r1[0].sleeping and r1[0].markers
    assert r1[0].meters_to_px_ratio is not None
