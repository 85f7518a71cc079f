"""Slanted-plane adaptive-support-weight window cost over precomputed volumes.

This is the hot path of the whole engine: every PatchMatch phase funnels into
"evaluate candidate plane(s) at every pixel", the dense replacement for
the reference's per-pixel virtual call IPlaneCost::GetPlaneCost
(plane_cost/pre_ss_pc.cc:74-118, pre_cs_pc.cc:133-188).

Semantics reproduced exactly:
  * support window wnd x wnd centered at the pixel, window pixels outside the
    image are skipped (pre_ss_pc.cc:84-91);
  * per window pixel q: weight w = exp(-(|dB|+|dG|+|dR|)/gamma) between the
    *center* color and q's color in the reference view (the reference reads a
    1000-entry LUT of exp(-i/gamma) at the integer L1 distance, which equals
    the direct exp of the same integer, pre_ss_pc.cc:61-64,92-98);
  * hypothesis disparity at q: d_q = a*q_x + b*q_y + c; the volume is sampled
    with *linear interpolation between integer slices* floor(d_q), floor+1
    (pre_ss_pc.cc:99-111);
  * the reference computes floor with a C truncation cast, so any d_q < 1 or
    trunc(d_q) >= max_dis takes the saturation branch: the contribution
    becomes w * max(volume) (pre_ss_pc.cc:50-58,101-103);
  * the cross-scale variant re-anchors the plane through the coarse-grid
    point ((x >> s), (y >> s), d/2^s) with the same orientation and sums the
    per-scale window costs with the inter-scale weights (pre_cs_pc.cc:133-188).

Restructured for a data-parallel device: all pixels and all K candidate
planes are evaluated in one dense program; a lax.fori_loop walks the
wnd*wnd window offsets.  The
evaluation runs in "scatter form": for window offset o, the per-center
quantities (candidate plane disparity at q, center color) are rolled *to the
window-pixel frame q = c + o*, so the cost-volume lookup indexes position
(q, f(q)) -- an aligned minor-axis take_along_axis that XLA vectorizes --
and the weighted contribution is rolled back to the center frame and
accumulated.  This is the jnp authority: the CPU tests check it, and the
fused GPU kernel (ops.pallas.window_cost) is checked against it.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp


def _trunc(x: jax.Array) -> jax.Array:
    """C-style truncation toward zero (static_cast<int>)."""
    return jnp.trunc(x).astype(jnp.int32)


def stride_start(half_wnd: int, stride: int) -> int:
    """First window offset for one axis at the given sampling stride.

    The strided prescreen grid starts at -half_wnd, which skips the center
    offset 0 whenever half_wnd is not a stride multiple (the default
    wnd=35/stride=2 case).  That is deliberate, and measured: anchoring the
    grid on 0 instead (dropping the +-half_wnd edge samples) degraded mean
    bad-pixel 0.0114 -> 0.0167 over 6 seeds on the oracle-parity scene
    (64x96, wnd=15, GRD+PP) -- worse even than exact full-window ranking
    (0.0133).  Adjacent-to-center samples sit in the ASW weight plateau and
    carry nearly the center's information, while the edge samples extend
    the ranking's spatial reach; the ranking noise a strided grid adds is
    mildly beneficial exploration for the stochastic optimizer.
    """
    return -half_wnd


def window_plane_cost(img_u8: jax.Array, vol: jax.Array, max_cost: jax.Array,
                      abc: jax.Array, *, half_wnd: int, max_dis: int,
                      gamma: float, center_row0: int = 0,
                      row_valid: jax.Array | None = None,
                      center_col0: int = 0,
                      col_valid: jax.Array | None = None,
                      wnd_stride: int = 1) -> jax.Array:
    """Single-scale, fine-grid plane cost for K candidate plane fields.

    Args:
      img_u8: u8[Ha, W, 3] reference-view image (channel order irrelevant).
        Ha may exceed the output height when the caller pre-extends rows with
        halo data for spatial sharding.
      vol: f32[Ha, W, D] cost volume, D = max_dis + 1.
      max_cost: f32 scalar, max over the volume (saturation value).
      abc: f32[K, H, W, 3] candidate plane parameters; output row y maps to
        array row y + center_row0.
      center_row0: array row of the first output row (halo depth when the
        caller pre-extends; 0 for the plain single-device path).
      row_valid: optional bool[Ha] marking array rows that are inside the
        global image (halo rows received from a neighbor shard are valid;
        rows past the global border are not).  Defaults to all rows valid;
        rows outside [0, Ha) are always invalid.
      center_col0 / col_valid: the column analogues, for callers whose
        columns are also sharded (Wa may exceed the output width).
      wnd_stride: evaluate only every wnd_stride-th window offset per axis
        (candidate prescreening -- an approximation of the full cost used
        for ranking, NOT the reference semantics; keep 1 for true costs).

    Plane parameters are evaluated against *output-grid* (local) coordinates;
    for sharded evaluation the caller re-anchors planes into local row
    coordinates (c' = c + b * row_offset) so the same (a, b, c) convention
    holds on every shard.

    Returns:
      f32[K, H, W] aggregated window costs.
    """
    ha, wa, _ = img_u8.shape
    k, h, w = abc.shape[0], abc.shape[-3], abc.shape[-2]
    wnd = 2 * half_wnd + 1
    o_start = stride_start(half_wnd, wnd_stride)
    offs = [(dy, dx)
            for dy in range(o_start, half_wnd + 1, wnd_stride)
            for dx in range(o_start, half_wnd + 1, wnd_stride)]
    img_i32 = img_u8.astype(jnp.int32)
    inv_gamma = jnp.float32(1.0 / gamma)

    # Embed the (a, b) fields and the per-center plane disparity into the
    # array frame (identity when centers span the whole array).
    ys_c = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs_c = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    d_center = abc[..., 0] * xs_c + abc[..., 1] * ys_c + abc[..., 2]
    if ha != h or wa != w:
        pad = ((0, 0), (center_row0, ha - center_row0 - h),
               (center_col0, wa - center_col0 - w))
        a_f = jnp.pad(abc[..., 0], pad)
        b_f = jnp.pad(abc[..., 1], pad)
        d_f = jnp.pad(d_center, pad)
    else:
        a_f, b_f, d_f = abc[..., 0], abc[..., 1], d_center

    ys = jax.lax.broadcasted_iota(jnp.int32, (ha, wa), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (ha, wa), 1)
    q_row_ok = (row_valid[:, None] if row_valid is not None
                else jnp.ones((ha, 1), bool))
    if col_valid is not None:
        q_row_ok = q_row_ok & col_valid[None, :]

    n_per_row = len(range(o_start, half_wnd + 1, wnd_stride))

    def body(o, acc):
        dy = (o // n_per_row) * wnd_stride + o_start
        dx = (o % n_per_row) * wnd_stride + o_start
        # Roll per-center fields to the q = c + (dy, dx) frame.
        dq = jnp.roll(
            d_f + a_f * dx + b_f * dy, (dy, dx), axis=(-2, -1))
        c_img = jnp.roll(img_i32, (dy, dx), axis=(0, 1))
        # Validity: the rolled-from center must exist (no wraparound), be a
        # real center row, and the q row must be inside the global image.
        cy = ys - dy
        cx = xs - dx
        c_ok = ((cy >= center_row0) & (cy < center_row0 + h)
                & (cx >= center_col0) & (cx < center_col0 + w))
        m = c_ok & q_row_ok

        l1 = jnp.sum(jnp.abs(c_img - img_i32), axis=-1).astype(jnp.float32)
        wgt = jnp.exp(-l1 * inv_gamma)

        f = _trunc(dq)
        in_range = (f >= 1) & (f <= max_dis - 1)
        fc = jnp.clip(f, 0, max_dis - 1)
        v_f = jnp.take_along_axis(vol[None], fc[..., None], axis=-1)[..., 0]
        v_c = jnp.take_along_axis(vol[None], fc[..., None] + 1,
                                  axis=-1)[..., 0]
        floor_wgt = (fc + 1).astype(jnp.float32) - dq
        val = floor_wgt * v_f + (1.0 - floor_wgt) * v_c
        val = jnp.where(in_range, val, max_cost)
        contrib = jnp.where(m, wgt * val, 0.0)
        return acc + jnp.roll(contrib, (-dy, -dx), axis=(-2, -1))

    # derive the accumulator from every body input so loop-carry sharding
    # metadata (shard_map varying-axes) matches inside and outside the
    # loop: the body's contribution varies over whatever mesh axes the
    # planes, image, volume, saturation value, or validity masks vary over
    z0 = (0.0 * d_f + 0.0 * img_i32[0, 0, 0].astype(jnp.float32)
          + 0.0 * vol[0, 0, 0] + 0.0 * max_cost
          + 0.0 * q_row_ok[0, 0].astype(jnp.float32))
    acc0 = jnp.zeros((k, ha, wa), jnp.float32) + z0
    acc = jax.lax.fori_loop(0, len(offs), body, acc0)
    acc = jax.lax.slice_in_dim(acc, center_row0, center_row0 + h, axis=1)
    return jax.lax.slice_in_dim(acc, center_col0, center_col0 + w, axis=2)


def upsample_level(coarse: jax.Array, scale: int, half_wnd: int,
                   fine_hw: tuple, row0: jax.Array | int = 0,
                   col0: jax.Array | int = 0) -> jax.Array:
    """Nearest-neighbor upsample of a level-s array to the fine grid, with a
    half_wnd * 2^s margin on every side for wrap-free window rolls.

    The margin region repeats the *edge-clamped* coarse values; a separate
    validity mask (see `upsample_valid`) marks which padded-fine positions
    correspond to real coarse pixels.

    Args:
      coarse: [Hs, Ws, ...] level-s array.
      fine_hw: (H, W) fine-grid shape (a spatially-sharded caller passes
        its band height and the band's global starting row as row0).

    Returns:
      [(H + 2M), (W + 2M), ...] with M = half_wnd << scale; position
      (M + y, M + x) holds coarse[(row0 + y) >> s, (col0 + x) >> s].
    """
    h, w = fine_hw
    step = 1 << scale
    m = half_wnd * step
    hs, ws = coarse.shape[0], coarse.shape[1]
    ry = jnp.clip((jnp.arange(-m, h + m) + row0) >> scale, 0, hs - 1)
    rx = jnp.clip((jnp.arange(-m, w + m) + col0) >> scale, 0, ws - 1)
    return jnp.take(jnp.take(coarse, ry, axis=0), rx, axis=1)


def upsample_valid(scale: int, half_wnd: int, fine_hw: tuple,
                   coarse_hw: tuple,
                   row0: jax.Array | int = 0,
                   col0: jax.Array | int = 0) -> jax.Array:
    """bool[(H+2M), (W+2M)]: padded-fine positions mapping to a real
    level-s pixel (the window-skip condition of pre_cs_pc.cc:152-159)."""
    h, w = fine_hw
    hs, ws = coarse_hw
    step = 1 << scale
    m = half_wnd * step
    fy = jnp.arange(-m, h + m) + row0
    fx = jnp.arange(-m, w + m) + col0
    vy = (fy >= 0) & ((fy >> scale) < hs)
    vx = (fx >= 0) & ((fx >> scale) < ws)
    return vy[:, None] & vx[None, :]


def window_plane_cost_upsampled(img_up: jax.Array, vol_up: jax.Array,
                                valid_up: jax.Array, max_cost_s: jax.Array,
                                abc0: jax.Array, *, scale: int, half_wnd: int,
                                max_dis_s: int, gamma: float) -> jax.Array:
    """Per-scale window cost on the fine grid via upsampled level-s arrays.

    Every fine pixel (x, y) owns its own plane; at pyramid level s the window
    centers at (x >> s, y >> s) in the level-s arrays and the plane is
    re-anchored through (x >> s, y >> s, d0 / 2^s) keeping (a, b)
    (pre_cs_pc.cc:139-144,183-185).  The window size is NOT scaled
    (pre_cs_pc.cc:135).

    Scatter form: a coarse window offset (dy, dx) is a *fine* shift of
    (dy, dx) * 2^s on the upsampled arrays -- ((p + o*2^s) >> s) equals
    (p >> s) + o -- so the volume lookup is again an aligned minor-axis
    take_along_axis.  The margin baked into the upsampled arrays keeps every
    roll wrap outside the readable interior.  The hypothesis disparity at
    the window pixel reduces to d0/2^s + a*dx + b*dy, independent of the
    coarse coordinates.

    Args:
      img_up / vol_up / valid_up: outputs of upsample_level/upsample_valid.
      abc0: f32[K, H, W, 3] fine-grid plane parameters.

    Returns:
      f32[K, H, W].
    """
    k, h, w, _ = abc0.shape
    step = 1 << scale
    m = half_wnd * step
    ds = vol_up.shape[-1]
    wnd = 2 * half_wnd + 1
    img_i32 = img_up.astype(jnp.int32)
    inv_gamma = jnp.float32(1.0 / gamma)

    ys_c = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs_c = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    a = abc0[..., 0]
    b = abc0[..., 1]
    d0 = a * xs_c + b * ys_c + abc0[..., 2]
    pad = ((0, 0), (m, m), (m, m))
    a_f = jnp.pad(a, pad)
    b_f = jnp.pad(b, pad)
    d_f = jnp.pad(d0 * jnp.float32(1.0 / step), pad)

    hp, wp = h + 2 * m, w + 2 * m
    ys = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 1)

    def body(o, acc):
        dy = o // wnd - half_wnd
        dx = o % wnd - half_wnd
        sy = dy * step
        sx = dx * step
        dq = jnp.roll(d_f + a_f * dx + b_f * dy, (sy, sx), axis=(-2, -1))
        c_img = jnp.roll(img_i32, (sy, sx), axis=(0, 1))
        # center must be interior; q must map to a real coarse pixel
        c_ok = ((ys - sy >= m) & (ys - sy < m + h)
                & (xs - sx >= m) & (xs - sx < m + w))
        mask = c_ok & valid_up

        l1 = jnp.sum(jnp.abs(c_img - img_i32), axis=-1).astype(jnp.float32)
        wgt = jnp.exp(-l1 * inv_gamma)

        f = _trunc(dq)
        in_range = (f >= 1) & (f <= max_dis_s - 1)
        fc = jnp.clip(f, 0, max(max_dis_s - 1, 0))
        v_f = jnp.take_along_axis(vol_up[None], fc[..., None], axis=-1)[..., 0]
        v_c = jnp.take_along_axis(vol_up[None],
                                  jnp.minimum(fc[..., None] + 1, ds - 1),
                                  axis=-1)[..., 0]
        floor_wgt = (fc + 1).astype(jnp.float32) - dq
        val = floor_wgt * v_f + (1.0 - floor_wgt) * v_c
        val = jnp.where(in_range, val, max_cost_s)
        contrib = jnp.where(mask, wgt * val, 0.0)
        return acc + jnp.roll(contrib, (-sy, -sx), axis=(-2, -1))

    z0 = (0.0 * d_f + 0.0 * img_i32[0, 0, 0].astype(jnp.float32)
          + 0.0 * vol_up[0, 0, 0] + 0.0 * max_cost_s
          + 0.0 * valid_up[0, 0].astype(jnp.float32))
    acc0 = jnp.zeros((k, hp, wp), jnp.float32) + z0
    acc = jax.lax.fori_loop(0, wnd * wnd, body, acc0)
    return acc[:, m:m + h, m:m + w]


def cross_scale_plane_cost(pyr_imgs: Sequence[jax.Array],
                           pyr_vols: Sequence[jax.Array],
                           pyr_max_costs: Sequence[jax.Array],
                           scale_wgts: Sequence[float], abc0: jax.Array, *,
                           half_wnd: int, max_dis: int,
                           gamma: float) -> jax.Array:
    """Cross-scale aggregated plane cost: sum_s wgt_s * cost_s
    (pre_cs_pc.cc:182).

    Args:
      pyr_imgs / pyr_vols / pyr_max_costs: per-level data, level 0 finest
        (coarse levels at their native resolution; upsampling happens here).
      scale_wgts: inter-scale regularization weights (ops.scale_weights).
      abc0: f32[K, H, W, 3] fine-grid plane parameters.

    Returns:
      f32[K, H, W].
    """
    h, w, _ = pyr_imgs[0].shape
    total = None
    md = max_dis
    for s, (img_s, vol_s, mc_s) in enumerate(
            zip(pyr_imgs, pyr_vols, pyr_max_costs)):
        if s == 0:
            cost_s = window_plane_cost(img_s, vol_s, mc_s, abc0,
                                       half_wnd=half_wnd, max_dis=md,
                                       gamma=gamma)
        else:
            img_up = upsample_level(img_s, s, half_wnd, (h, w))
            vol_up = upsample_level(vol_s, s, half_wnd, (h, w))
            valid_up = upsample_valid(s, half_wnd, (h, w), img_s.shape[:2])
            cost_s = window_plane_cost_upsampled(
                img_up, vol_up, valid_up, mc_s, abc0, scale=s,
                half_wnd=half_wnd, max_dis_s=md, gamma=gamma)
        term = jnp.float32(scale_wgts[s]) * cost_s
        total = term if total is None else total + term
        md //= 2
    return total
