"""Mesh-sharded batch pipeline: the multi-chip story.

The reference is strictly single-GPU (SURVEY.md section 2: no NCCL/MPI — the
only "distributed" channel is a WebSocket). The accelerator extension that
actually makes sense for this workload is throughput scaling: a *batch of
frames* (multiple game clients / a capture backlog / offline video analysis)
laid out over a 2D mesh:

  * axis "dp": frames across chips (pure data parallelism),
  * axis "sp": image rows across chips (spatial partitioning within a frame).

Everything is expressed as ONE jitted function with sharding annotations —
XLA's SPMD partitioner inserts the halo exchanges the dilations need at the
"sp" seams and keeps the elementwise HSV work local (the scaling-book recipe:
pick a mesh, annotate, let XLA place collectives on ICI).

The batched LSD march vmaps the single-frame chunked march over the batch
axis; each frame's 3600 rays stay on the chip that owns the frame.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import consts as C
from ..ops import lsd as ops_lsd
from ..ops import pipeline as ops_pipeline


def make_mesh(devices: Optional[list] = None, sp: int = 1) -> Mesh:
    """Build a ("dp", "sp") mesh from the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    assert n % sp == 0, f"{n} devices not divisible by sp={sp}"
    arr = np.asarray(devices).reshape(n // sp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


@functools.partial(
    jax.jit, static_argnames=("frame_h", "frame_w", "grayscale", "mesh_in")
)
def _analyze_batch(frames, frame_h, frame_w, grayscale, mesh_in=None):
    g = C.map_geometry(frame_w, frame_h)

    def per_frame(frame):
        map_bgra = jax.lax.slice(
            frame, (g.map_y, g.map_x, 0), (g.map_y + g.map_h, g.map_x + g.map_w, 4)
        )
        out = ops_pipeline._analyze_map(map_bgra, grayscale=grayscale, with_isolated=False)
        btn = jax.lax.slice(
            frame, (g.btn_y, g.btn_x, 0), (g.btn_y + g.btn_h, g.btn_x + g.btn_w, 4)
        )
        out["red_ratio"] = ops_pipeline._red_gate_roi(btn)
        return out

    return jax.vmap(per_frame)(frames)


def analyze_batch(frames: jax.Array, mesh: Mesh, grayscale: bool = True) -> dict:
    """Run the fused pass on a frame batch sharded (dp=batch, sp=rows).

    frames: u8 [B, H, W, 4]. Returns the per-frame outputs with the batch
    axis sharded over "dp"; ui_map/lsd_mask rows sharded over "sp".
    """
    b, h, w, _ = frames.shape
    in_sharding = NamedSharding(mesh, P("dp", "sp", None, None))
    frames = jax.device_put(frames, in_sharding)
    return _analyze_batch(frames, frame_h=h, frame_w=w, grayscale=grayscale)


def march_batch(masks: jax.Array, pts: jax.Array, mesh: Mesh, max_gap: int = C.LSD_MAX_GAP):
    """Batched longest-line march: one seed per frame.

    masks: u8 [B, mh, mw] (dp-sharded), pts: f32 [B, 2].
    Returns (ends [B, N, 2], lengths [B, N]) — reduce with argmax on host or
    device as needed.
    """
    b, mh, mw = masks.shape
    max_k = ops_lsd._max_k(mh, mw)

    sharding = NamedSharding(mesh, P("dp"))
    masks = jax.device_put(masks, sharding)
    pts = jax.device_put(pts, sharding)

    @functools.partial(jax.jit, static_argnames=())
    def _batched(masks, pts):
        def one(mask, pt):
            return ops_lsd._march(mask, pt, h=mh, w=mw, max_gap=max_gap, max_k=max_k)

        return jax.vmap(one)(masks, pts)

    return _batched(masks, pts)


def full_step(frames: jax.Array, pts: jax.Array, mesh: Mesh) -> dict:
    """One complete sharded "step": fused analyze over (dp, sp) + batched
    ray march over dp + deterministic per-frame winner reduce.

    This is the function `__graft_entry__.dryrun_multichip` compiles over an
    N-device mesh to validate the multi-chip shardings.
    """
    outs = analyze_batch(frames, mesh)
    masks = outs["lsd_mask"]
    # March wants the full mask rows local to the frame's chip: reshard from
    # (dp, sp) to (dp,) — XLA emits the all-gather along "sp" on ICI.
    masks = jax.device_put(masks, NamedSharding(mesh, P("dp")))
    ends, lengths = march_batch(masks, pts, mesh)
    # Ties -> last angle, like the oracle's right-biased fold and the
    # single-chip reducers (ops/lsd._finalize).
    n = lengths.shape[1]
    best = (n - 1) - jnp.argmax(lengths[:, ::-1], axis=1)
    best_ends = jnp.take_along_axis(ends, best[:, None, None], axis=1)[:, 0]
    best_len = jnp.take_along_axis(lengths, best[:, None], axis=1)[:, 0]
    return {
        "red_ratio": outs["red_ratio"],
        "ui": outs["ui"],
        "best_end": best_ends,
        "best_length_sqr": best_len,
    }
