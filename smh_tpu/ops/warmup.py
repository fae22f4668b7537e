"""AOT warmup of the per-resolution jit buckets.

The reference vendors pre-built PTX for six compute capabilities so first
launch never pays nvcc (vision-gpu/build.rs:92-158, cuda.rs:60-66). The XLA
equivalent is the persistent compilation cache (smh_tpu/jax_cache.py) plus
this warmup: compile every bucket a deployment will use, up front, instead
of stuttering on the first frame of each resolution.

Buckets per resolution: the fused pass per LSD window rung (the backend's
adaptive ladder re-jits when the window grows/shrinks), the quiet-mask-off
variant (minimap cadence frames), and the ray-march span shapes.
"""

from __future__ import annotations

import logging
import time

log = logging.getLogger(__name__)

COMMON_RESOLUTIONS = ((1920, 1080), (2560, 1440), (3840, 2160))


def warmup(resolutions=COMMON_RESOLUTIONS, grayscale: bool = True) -> None:
    """Compile (or cache-load) the fused pass + march for each resolution."""
    from .. import consts as C, testing
    from ..vision.tpu_backend import TpuBackend

    for w, h in resolutions:
        t0 = time.time()
        be = TpuBackend()
        # Default engines (smhocr) take the on-device scales reader; the
        # binary band transport stays warm as the SMH_DEVICE_SCALES=0 /
        # overflow-session fallback.
        be.scales_binary_ok = True
        be.scales_image_derived = True
        be.scales_device_ok = True
        frame = testing.make_frame(w, h, marker_lines=[((50, 50), (200, 120))])
        be.load_frame(frame)
        out = be.crop_to_map(grayscale)
        if out is not None:
            be.find_marker_lines(C.LSD_MAX_GAP)
        # Mask-transport buckets. Sparse mode (the default): each word-budget
        # rung is its own compiled shape — warm the default rung and its
        # escalation neighbourhood (live sessions start at _SP_RUNG_DEFAULT
        # and step at most a few rungs). Window mode (SMH_SPARSE=0): warm the
        # 2-D ladder's matched-rung diagonal instead.
        from ..vision.tpu_backend import (
            _RUNG_HALF,
            _SP_RUNG_DEFAULT,
            _SPARSE_BUDGETS,
            _dim_ladder,
            _sparse_mode,
        )

        if _sparse_mode():
            for rung in range(
                max(0, _SP_RUNG_DEFAULT - 1),
                min(len(_SPARSE_BUDGETS), _SP_RUNG_DEFAULT + 3),
            ):
                be._sp_rung = rung
                be._sp_streak = 0
                be.dispatch(grayscale)
                be.crop_to_map(grayscale)
                be._sp_rung = rung  # undo the consume-side shrink bookkeeping
            be._sp_rung = _SP_RUNG_DEFAULT
            # The probation fallback bucket: after repeated sparse misses
            # (dense content) the backend steps aside to the WINDOW ladder
            # at its starting rung — compile that shape too, or the step-
            # aside pays a live mid-session compile. (Escalations past
            # rung _SP_RUNG_DEFAULT+2 land on dense scenes that are headed
            # for this same probation, so the window bucket covers them.)
            be._sp_probation = 1
            be.dispatch(grayscale)
            be.crop_to_map(grayscale)
            # A live session must start with VIRGIN hysteresis: the warm
            # frames above advanced the shrink/miss streaks on synthetic
            # content (consume-side _adapt_sp_rung runs on every
            # crop_to_map), and inheriting that residue would bias the
            # first real shrink/step-aside decisions.
            be._sp_probation = 0
            be._sp_miss_streak = 0
            be._sp_streak = 0
            be._sp_rung = _SP_RUNG_DEFAULT
        elif be._ladder_h is not None:
            for rung in range(len(be._ladder_h)):
                be._rung_h = be._rung_w = rung
                be.dispatch(grayscale)
                be.crop_to_map(grayscale)
            be._rung_h = be._rung_w = _RUNG_HALF
        # Band-rung buckets (binary transport). The band ladder only runs
        # when the device reader is off (fallback engines), so warming EVERY
        # rung paid ~4 rarely-hit compiles per resolution of the 980 s
        # round-3 cold start. Warm the two rungs a fallback session actually
        # starts in: the default (1/2) and the full-height escape hatch; a
        # band session that adapts beyond them pays its own compile, once.
        be.scales_device_ok = False
        ladder_len = len(_dim_ladder(be.geom.brq_h))
        for band_rung in {min(_RUNG_HALF, ladder_len - 1), ladder_len - 1}:
            be._band_rung = band_rung
            be.dispatch(grayscale)
            be.crop_to_map(grayscale)
        be._band_rung = _RUNG_HALF
        be._band_streak = 0
        be._band_probation = 0
        be.scales_device_ok = True
        # Delta-transport buckets: warm the chunk-count buckets a live
        # session typically visits (a marker drag is a few hundred chunks).
        if be._delta_active(be._pending_host.size if be._pending_host is not None else 0):
            import numpy as np

            from ..vision.tpu_backend import _DELTA_SUB

            g = be.geom
            for n_touch in (100, 1000):
                f2 = frame.copy()
                span = min(g.map_w - 60, (n_touch * _DELTA_SUB) // 9)
                f2[
                    g.map_y + 40 : g.map_y + 43, g.map_x + 50 : g.map_x + 50 + span, :3
                ] = np.uint8(200)
                be.load_frame(f2)
                be.crop_to_map(grayscale)
                be.load_frame(frame)
                be.crop_to_map(grayscale)
                frame = f2  # alternate so each load really diffs
        # Scales-transport variants the live loop flips between: inline
        # ("binary" warmed above) and checksum-only ("none" — entered after
        # a few stable frames on any static map; device engines never drop
        # to it, so warm it with the device reader off).
        be.scales_device_ok = False
        be._scales_inline = False
        be.dispatch(grayscale)
        be.crop_to_map(grayscale)
        be._scales_inline = True
        be.scales_device_ok = True
        # Minimap-cadence variant (minimap rect dropped from the pack).
        be.quiet_enabled = False
        be.dispatch(grayscale)
        be.crop_to_map(grayscale)
        be.quiet_enabled = True
        log.info("warmup %dx%d: %.1fs", w, h, time.time() - t0)
