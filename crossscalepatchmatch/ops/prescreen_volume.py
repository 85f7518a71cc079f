"""Pre-aggregated ASW quadrant volumes for cheap candidate prescreening.

The strided-window prescreen (ops.plane_cost wnd_stride) still evaluates
~(wnd/stride)^2 window samples per candidate.  This module precomputes,
ONCE per pair, the ASW-weighted window aggregation of the cost volume
split into 2x2 window quadrants:

    B_Q[c, d] = sum_{q in quadrant Q of c's window} w(c, q) * vol[q, d]
    W_Q[c]    = sum_{q in Q} w(c, q)

After that, ranking a candidate plane costs FOUR volume lerps per pixel
instead of hundreds of window samples: the plane's disparity is evaluated
at each quadrant's anchor offset and linearly interpolated into B_Q
(out-of-range anchors saturate at W_Q * max_cost, mirroring
pre_ss_pc.cc:101-103).  For a fronto-parallel plane with all anchors in
range this equals the exact window cost; slant is ranked through the
anchor-point disparity differences.

This is an optimizer-search heuristic exactly like the strided prescreen:
adoption still compares full-window exact costs (models.patchmatch), so
the reference cost semantics are untouched.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def quadrant_anchors(half_wnd: int) -> Tuple[Tuple[float, float], ...]:
    """(dy, dx) anchor offsets of the 2x2 window quadrants: the centroid
    of each quadrant's offset range (quadrant Q00 spans dy,dx in
    [-half_wnd, 0), etc.; the dy==0 / dx==0 lines belong to the +side)."""
    lo = -(half_wnd + 1) / 2.0          # centroid of [-half_wnd, -1]
    hi = half_wnd / 2.0                 # centroid of [0, half_wnd]
    return ((lo, lo), (lo, hi), (hi, lo), (hi, hi))


@functools.partial(jax.jit, static_argnames=("half_wnd", "gamma", "stride"))
def build_quadrant_volumes(img_u8: jax.Array, vol: jax.Array,
                           valid: jax.Array | None = None, *,
                           half_wnd: int, gamma: float, stride: int = 2):
    """ASW-weighted quadrant aggregation of a cost volume.

    One fori_loop PER quadrant (each offset touches exactly one quadrant
    accumulator -- a single loop with one-hot writes into all four
    doubles the accumulator traffic through device memory).  `stride` subsamples the window offsets like the strided
    window prescreen (this is a ranking structure, not an exact cost;
    stride 2 quarters the build's memory traffic).

    Args:
      img_u8: u8[H, W, 3] reference view (or a shard's halo-extended
        block).
      vol: f32[H, W, D].
      valid: optional bool[H, W] marking real image pixels -- a spatially
        sharded caller passes its extended block's global-border clip so
        neighbor-halo pixels count while pixels past the global image
        border do not.  Defaults to the array extent.

    Returns:
      (bq: f32[4, H, W, D], wq: f32[4, H, W]) -- quadrant order matches
      quadrant_anchors.  Window pixels outside the (valid) image
      contribute nothing (the reference's window clip,
      pre_ss_pc.cc:84-91).
    """
    h, w, _ = img_u8.shape
    img_i32 = img_u8.astype(jnp.int32)
    inv_gamma = jnp.float32(1.0 / gamma)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    in_extent = None if valid is None else valid

    neg = list(range(-half_wnd, 0, stride))        # quadrant's -side
    pos = list(range(0, half_wnd + 1, stride))     # 0 belongs to the +side
    ranges = {False: neg, True: pos}

    def one_quadrant(y_pos: bool, x_pos: bool):
        dys = jnp.asarray(ranges[y_pos], jnp.int32)
        dxs = jnp.asarray(ranges[x_pos], jnp.int32)
        nx = len(ranges[x_pos])

        def body(o, acc):
            b, wsum = acc
            dy = dys[o // nx]
            dx = dxs[o % nx]
            q_img = jnp.roll(img_i32, (-dy, -dx), axis=(0, 1))
            q_vol = jnp.roll(vol, (-dy, -dx), axis=(0, 1))
            ok = ((ys + dy >= 0) & (ys + dy < h)
                  & (xs + dx >= 0) & (xs + dx < w))
            if in_extent is not None:
                ok = ok & jnp.roll(in_extent, (-dy, -dx), axis=(0, 1))
            l1 = jnp.sum(jnp.abs(q_img - img_i32),
                         axis=-1).astype(jnp.float32)
            wgt = jnp.where(ok, jnp.exp(-l1 * inv_gamma), 0.0)
            return b + wgt[..., None] * q_vol, wsum + wgt

        # derive the accumulators from every body input so the loop-carry
        # sharding metadata (shard_map varying-axes) matches the body's
        # output
        z = (0.0 * vol[0, 0, 0]
             + 0.0 * img_i32[0, 0, 0].astype(jnp.float32))
        if in_extent is not None:
            z = z + 0.0 * in_extent[0, 0].astype(jnp.float32)
        b0 = jnp.zeros_like(vol) + z
        w0 = jnp.zeros(vol.shape[:2], jnp.float32) + z
        n = len(ranges[y_pos]) * nx
        return jax.lax.fori_loop(0, n, body, (b0, w0))

    parts = [one_quadrant(yp, xp) for yp in (False, True)
             for xp in (False, True)]
    return (jnp.stack([p[0] for p in parts]),
            jnp.stack([p[1] for p in parts]))


def quadrant_prescreen_cost(bq: jax.Array, wq: jax.Array,
                            max_cost: jax.Array, abc: jax.Array, *,
                            half_wnd: int, max_dis: int) -> jax.Array:
    """Approximate window cost of K candidate plane fields from the
    quadrant volumes: sum_Q lerp(B_Q[c], dq(anchor_Q)) with out-of-range
    anchors saturating at W_Q[c] * max_cost.

    Args:
      bq / wq: build_quadrant_volumes outputs.
      abc: f32[K, H, W, 3].

    Returns:
      f32[K, H, W] ranking costs (NOT the exact window cost -- use only
      to pick argmin candidates).
    """
    k, h, w, _ = abc.shape
    d = bq.shape[-1]
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    d_center = abc[..., 0] * xs + abc[..., 1] * ys + abc[..., 2]
    # The lerp is evaluated as the dense tent contraction
    # sum_d B_Q[c,d] * max(0, 1-|dq-d|) rather than a floor/ceil
    # take_along_axis (~D fma per pixel per quadrant); a two-tap gather
    # form reads 2 of D values instead (ROADMAP Speed #4).
    d_io = jnp.arange(d, dtype=jnp.float32)
    total = jnp.zeros((k, h, w), jnp.float32)
    for qi, (ay, ax) in enumerate(quadrant_anchors(half_wnd)):
        dq = d_center + abc[..., 0] * ax + abc[..., 1] * ay
        f = jnp.trunc(dq)
        in_range = (f >= 1.0) & (f <= max_dis - 1.0)
        tent = jnp.maximum(0.0, 1.0 - jnp.abs(dq[..., None] - d_io))
        val = jnp.sum(bq[qi][None] * tent, axis=-1)
        total = total + jnp.where(in_range, val, wq[qi] * max_cost)
    return total
