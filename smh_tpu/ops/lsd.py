"""Device longest-line search: 3600 rays/seed, dense span scans, batched seeds.

Replaces the reference's per-seed CUDA kernel (<<<8,450>>>, one thread per
0.1 degree, data-dependent while loop + block atomicMax/atomicCAS claim,
/root/reference/vision-gpu/cuda/cuda.cu:637-739, vision-cpu/src/lib.rs:387-449)
with a dense, vectorized formulation:

  * every ray is a lane; positions along a ray form a dense step axis
    processed in fixed [B, N_ANGLES, K] spans;
  * the gap state machine becomes a windowed AND: a ray aborts at the first
    step where the last (max_gap+1) samples are all non-white. The window is
    computed with log2(window) shifted ANDs — elementwise work, no scan;
  * because the abort step k_a is by construction the completion of an
    exactly-(max_gap+1)-long run, the restored position is pos(k_a - max_gap)
    and the endpoint pos(k_a - max_gap - 1) — a closed form (positions are
    linear in k), so no argmax / take_along_axis is needed anywhere;
  * first-index reductions are sums of cumulative ANDs (plain add-reduces)
    instead of argmax / take_along_axis / min-over-iota along the minor
    axis: bool log-shift cumANDs + add-reduces stay vectorized;
  * out-of-bounds exit is the add-reduce of a prefix property (bounds are
    convex: once out, always out);
  * the winning angle is a deterministic argmax on the small [B, N] result
    (ties -> last angle, matching the reference fold's right bias) instead of
    an atomicCAS race.

Control flow lives on the HOST as fixed-shape span dispatches, not in a
lax.while_loop (the formulation this system was first tuned with; whether
one while_loop dispatch is cheaper on the H100 is ROADMAP Queue 3 item 2).
Span 1 finishes every
background seed (a ray dies after max_gap+1 background samples); only seeds
on real lines take further spans, each a fixed-shape dispatch with carried
state. Seeds are batched (bucketed to powers of two) so one dispatch marches
many seeds.

Positions use pos(k) = start + k*d in f32. The oracle accumulates d by
repeated addition; the two can differ by float ulps at cell boundaries, which
the detection thresholds absorb (validated on the golden corpus).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from .. import consts as C
from ..geometry import Line, Point

F32 = jnp.float32
I32 = jnp.int32

N_ANGLES = C.LSD_NUM_ANGLES
SPAN0 = 256  # first span: covers every background seed in one dispatch
SPAN = 512  # follow-up spans for rays still alive (real lines)


def _theta_tables():
    theta = (jnp.arange(N_ANGLES, dtype=F32) / F32(10.0)) * (F32(math.pi) / F32(180.0))
    return jnp.cos(theta), jnp.sin(theta)


def _cum_and(x: jnp.ndarray) -> jnp.ndarray:
    """Cumulative AND along the last axis via log-shifts (True-padded)."""
    out = x
    s = 1
    k = x.shape[2]
    while s < k:
        shifted = jnp.pad(out, ((0, 0), (0, 0), (s, 0)), constant_values=True)[:, :, :k]
        out = out & shifted
        s *= 2
    return out


def _windowed_all_black(black_ext: jnp.ndarray, window: int) -> jnp.ndarray:
    """out[..., k] = AND of black_ext[..., k-window+1 : k+1], via doubling.

    black_ext must carry `window-1` real samples of left context (the carry
    from the previous span); the left padding introduced by the shifts never
    reaches the returned region.
    """
    out = black_ext
    shift = 1
    remaining = window - 1
    while remaining > 0:
        s = min(shift, remaining)
        shifted = jnp.pad(out, ((0, 0), (0, 0), (s, 0)))[:, :, : out.shape[2]]
        out = out & shifted
        remaining -= s
        shift *= 2
    return out[:, :, window - 1 :]


@functools.partial(jax.jit, static_argnames=("h", "w", "max_gap", "kspan"))
def _march_span(
    mask: jnp.ndarray,  # u8 [h, w]
    pts: jnp.ndarray,  # f32 [B, 2]
    done: jnp.ndarray,  # bool [B, N]
    prev_black: jnp.ndarray,  # bool [B, N, max_gap] trailing blacks carry
    end_x: jnp.ndarray,  # f32 [B, N]
    end_y: jnp.ndarray,  # f32 [B, N]
    k0,  # i32 scalar (traced: spans advance without recompiling)
    h: int,
    w: int,
    max_gap: int,
    kspan: int,
):
    """March steps [k0, k0+kspan) for every (seed, angle) lane. Returns
    updated (done, prev_black, end_x, end_y, all_done_scalar)."""
    window = max_gap + 1
    mask_flat = mask.reshape(-1)
    dx, dy = _theta_tables()  # [n]

    x0 = pts[:, 0][:, None]  # [B,1]
    y0 = pts[:, 1][:, None]

    ks = jnp.int32(k0) + jax.lax.broadcasted_iota(I32, (1, 1, kspan), 2)
    kf = ks.astype(F32)
    px = x0[:, :, None] + dx[None, :, None] * kf  # [B, n, kspan]
    py = y0[:, :, None] + dy[None, :, None] * kf

    inb = (px >= 0) & (py >= 0) & (px < F32(w)) & (py < F32(h))
    xi = jnp.clip(px.astype(I32), 0, w - 1)
    yi = jnp.clip(py.astype(I32), 0, h - 1)
    white = (jnp.take(mask_flat, (yi * w + xi).reshape(-1), mode="clip").reshape(px.shape) == 255) & inb
    black = ~white

    # Run detection: first step whose trailing (max_gap+1) samples are all
    # black. The oracle aborts exactly when that run completes, restoring the
    # run's first position (vision-cpu:403-424).
    black_ext = jnp.concatenate([prev_black, black], axis=2)
    run_full = _windowed_all_black(black_ext, window)  # [B, n, kspan]
    abort_hit = run_full & inb

    # First-index reductions as sums of cumulative ANDs: bool cumAND
    # (log-shifts) + add-reduce stays fully vectorized, with no min-reduce
    # over a broadcast iota.
    ka_rel = jnp.sum(_cum_and(~abort_hit), axis=2, dtype=I32)  # first abort (or kspan)
    ko_rel = jnp.sum(inb, axis=2, dtype=I32)  # first oob (bounds are a prefix)

    abort_any = ka_rel < kspan
    oob_any = ko_rel < kspan
    ka = jnp.int32(k0) + ka_rel
    ko = jnp.int32(k0) + ko_rel

    # Abort endpoint (closed form): run start = ka - max_gap, endpoint one
    # step before it. The restored pixel is black, so the oracle's final
    # check (vision-cpu:426-429) always subtracts one step here.
    ks_end = (ka - jnp.int32(window)).astype(F32)
    abort_end_x = x0 + dx[None, :] * ks_end
    abort_end_y = y0 + dy[None, :] * ks_end

    # Out-of-bounds endpoint: final positional check with Rust's saturating
    # f32->u32 cast (negatives clamp to 0).
    kof = ko.astype(F32)
    fx = x0 + dx[None, :] * kof
    fy = y0 + dy[None, :] * kof
    cxi = jnp.maximum(fx, F32(0.0)).astype(I32)
    cyi = jnp.maximum(fy, F32(0.0)).astype(I32)
    final_inb = (cxi < w) & (cyi < h)
    fpix = jnp.take(
        mask_flat, (jnp.clip(cyi, 0, h - 1) * w + jnp.clip(cxi, 0, w - 1)).reshape(-1), mode="clip"
    ).reshape(fx.shape)
    final_black = final_inb & (fpix == 0)
    oob_end_x = jnp.where(final_black, fx - dx[None, :], x0)
    oob_end_y = jnp.where(final_black, fy - dy[None, :], y0)

    act = ~done
    finish_abort = act & abort_any
    finish_oob = act & ~abort_any & oob_any

    end_x = jnp.where(finish_abort, abort_end_x, jnp.where(finish_oob, oob_end_x, end_x))
    end_y = jnp.where(finish_abort, abort_end_y, jnp.where(finish_oob, oob_end_y, end_y))
    done = done | finish_abort | finish_oob
    prev_black = jnp.where(done[:, :, None], prev_black, black[:, :, kspan - max_gap :])

    return done, prev_black, end_x, end_y, done.all()


@jax.jit
def _finalize(pts: jnp.ndarray, end_x: jnp.ndarray, end_y: jnp.ndarray):
    """Per-seed winner: last angle with the maximal squared length."""
    lx = pts[:, 0][:, None] - end_x
    ly = pts[:, 1][:, None] - end_y
    lengths = lx * lx + ly * ly  # [B, n] f32
    rev = lengths[:, ::-1]
    best_rev = jnp.argmax(rev, axis=1)
    best = (lengths.shape[1] - 1) - best_rev
    bx = jnp.take_along_axis(end_x, best[:, None], axis=1)[:, 0]
    by = jnp.take_along_axis(end_y, best[:, None], axis=1)[:, 0]
    bl = jnp.take_along_axis(lengths, best[:, None], axis=1)[:, 0]
    return bx, by, bl


def _bucket(b: int) -> int:
    return 1 << max(0, (b - 1).bit_length())


def _max_k(h: int, w: int) -> int:
    diag = int(math.ceil(math.hypot(h, w))) + 2
    return ((diag + SPAN - 1) // SPAN) * SPAN


def find_longest_lines_batch(
    mask_dev: jax.Array, pts: list[Point], max_gap: float, max_len: float | None = None
) -> list[tuple[Line, float]]:
    """March a batch of seeds; returns (Line, length_sqr) per seed, in order.

    Exact oracle semantics per seed (see module docstring); one device
    dispatch for the common case, extra fixed-shape span dispatches only
    while some ray is still alive (i.e. tracking a real line).

    max_len: upper bound on any line length from these seeds (e.g. the
    diagonal of the white-pixel bounding box). When given, the exact number
    of spans is known up front — every ray provably dies within
    max_len + max_gap + 2 steps — so the spans are dispatched back-to-back
    with NO host sync in between (no per-span `bool(all_done)` readback)."""
    if not pts:
        return []
    h, w = mask_dev.shape
    b = len(pts)
    bb = _bucket(b)
    pts_np = np.zeros((bb, 2), dtype=np.float32)
    for i, p in enumerate(pts):
        pts_np[i] = (p.x, p.y)
    pts_dev = jnp.asarray(pts_np)

    n = N_ANGLES
    mg = int(max_gap)
    done = jnp.zeros((bb, n), dtype=bool)
    prev_black = jnp.zeros((bb, n, mg), dtype=bool)  # virtual pre-start: white
    end_x = jnp.broadcast_to(pts_dev[:, 0][:, None], (bb, n))
    end_y = jnp.broadcast_to(pts_dev[:, 1][:, None], (bb, n))

    max_k = _max_k(h, w)

    done, prev_black, end_x, end_y, all_done = _march_span(
        mask_dev, pts_dev, done, prev_black, end_x, end_y, 0, h=h, w=w, max_gap=mg, kspan=SPAN0
    )
    k = SPAN0
    if max_len is not None:
        # Known bound: dispatch the exact span count with no mid-loop sync
        # (the dispatches chain on device; one fetch at the end).
        needed = min(max_k, int(max_len) + mg + 2)
        while k < needed:
            done, prev_black, end_x, end_y, all_done = _march_span(
                mask_dev, pts_dev, done, prev_black, end_x, end_y, k, h=h, w=w, max_gap=mg, kspan=SPAN
            )
            k += SPAN
    else:
        while k < max_k and not bool(all_done):
            done, prev_black, end_x, end_y, all_done = _march_span(
                mask_dev, pts_dev, done, prev_black, end_x, end_y, k, h=h, w=w, max_gap=mg, kspan=SPAN
            )
            k += SPAN

    bx, by, bl = _finalize(pts_dev, end_x, end_y)
    bx = np.asarray(bx)
    by = np.asarray(by)
    bl = np.asarray(bl)

    out = []
    for i, p in enumerate(pts):
        line = Line(Point(float(p.x), float(p.y)), Point(float(bx[i]), float(by[i])))
        out.append((line, float(bl[i])))
    return out


def find_longest_line(
    mask_dev: jax.Array, pt: Point, max_gap: float, max_len: float | None = None
) -> tuple[Line, float]:
    """Single-seed convenience wrapper (backend-contract parity)."""
    return find_longest_lines_batch(mask_dev, [pt], max_gap, max_len=max_len)[0]


# ---------------------------------------------------------------------------
# Batched device march used by the multi-chip path (one seed per frame, no
# host control flow: fixed full-depth single span; used on tiny shapes and in
# the sharded step where per-frame early exit is not worth a host sync).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("h", "w", "max_gap", "max_k"))
def _march(mask: jnp.ndarray, pt: jnp.ndarray, h: int, w: int, max_gap: int, max_k: int):
    """mask u8 [h, w]; pt f32 [2] -> (ends f32 [N,2], lengths f32 [N])."""
    done = jnp.zeros((1, N_ANGLES), dtype=bool)
    prev_black = jnp.zeros((1, N_ANGLES, max_gap), dtype=bool)
    end_x = jnp.broadcast_to(pt[0][None, None], (1, N_ANGLES))
    end_y = jnp.broadcast_to(pt[1][None, None], (1, N_ANGLES))
    done, prev_black, end_x, end_y, _ = _march_span(
        mask, pt[None, :], done, prev_black, end_x, end_y, 0, h=h, w=w, max_gap=max_gap, kspan=max_k
    )
    ends = jnp.stack([end_x[0], end_y[0]], axis=1)
    lx = pt[0] - end_x[0]
    ly = pt[1] - end_y[0]
    return ends, lx * lx + ly * ly
