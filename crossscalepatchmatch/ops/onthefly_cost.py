"""On-the-fly slanted-plane window costs (no precomputed volume).

The reference ships two IPlaneCost families: the Pre* classes sample
precomputed cost volumes (ops.plane_cost here), and GrdPC / CSPC
(plane_cost/grd_pc.cc, plane_cost/cspc.cc) compute the TAD color+gradient
data term at query time against the *sub-pixel warped other view*:

  * ASW weight exp(-L1_BGR(center, q) / gamma) from a 1000-entry LUT of
    exp at the integer L1 distance (grd_pc.cc:61-64,111-117) -- equal to
    the direct exp of the same integer;
  * hypothesis disparity dq = a*q_x + b*q_y + c; trunc(dq) <= 0 or
    >= max_dis saturates the contribution at
    alpha*tau_clr + (1-alpha)*tau_grd (grd_pc.cc:120-123);
  * otherwise warp other_x = q_x -+ dq, floor_x = trunc(other_x),
    floor_wgt = floor_x + 1 - other_x, with floor/ceil columns wrapped by
    +-W (HandleBorder, commfunc.h:129-145), and the data term is
      clr = mean_ch |I_q - lerp(I_other)|   (truncated at tau_clr)
      grd = |G_q - lerp(G_other)|           (truncated at tau_grd)
    mixed alpha*clr + (1-alpha)*grd (grd_pc.cc:149-171); gradients are
    x-Sobel ksize=1 on float gray (grd_pc.cc:37-41);
  * CSPC re-anchors the plane through the decimated point
    ((x >> s), (y >> s), dq/2^s) with the same orientation per pyramid
    level and sums level costs with the tridiagonal scale weights
    (cspc.cc:107-182); the window size is not scaled.

This path is the *capability-parity* pendant of the reference's (itself
never instantiated by main.cc:97-114); the production path is the
precomputed volume + the window-cost evaluators of ops.plane_cost and
ops.pallas.window_cost.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp

from .color import bgr_to_rgb, rgb_to_gray_f32
from .gradient import sobel_x_k1
from .plane_cost import upsample_level, upsample_valid


def _trunc(x: jax.Array) -> jax.Array:
    return jnp.trunc(x).astype(jnp.int32)


def _handle_border(x: jax.Array, n: int) -> jax.Array:
    """Wrap by +-n (commfunc.h:129-145); inputs must lie in (-n, 2n)."""
    return jnp.where(x < 0, x + n, jnp.where(x >= n, x - n, x))


def gray_gradient(bgr_u8: jax.Array) -> jax.Array:
    """x-Sobel(ksize=1) of the float BT.601 gray (grd_pc.cc:37-41)."""
    return sobel_x_k1(rgb_to_gray_f32(bgr_to_rgb(bgr_u8)))


def _data_term(q_img, q_grd, oth_img, oth_grd, dq, q_x, q_y_rows, sign, *,
               w_oth: int, alpha: float, tau_clr: float, tau_grd: float):
    """TAD color+gradient vs the sub-pixel warped other view.

    q_img/q_grd: [..., H?, W] window-pixel values (any leading dims).
    oth_img/oth_grd: [Ho, Wo(,3)] other-view arrays to warp into.
    dq: hypothesis disparity at the window pixel, same shape as q_grd.
    q_x: window-pixel column index (same shape); q_y_rows: row index array
      broadcastable to it (rows of oth arrays to read).
    """
    other_x = q_x.astype(jnp.float32) + sign * dq
    fx = _trunc(other_x)
    floor_wgt = (fx + 1).astype(jnp.float32) - other_x
    fxw = _handle_border(fx, w_oth)
    cxw = _handle_border(fx + 1, w_oth)
    flat_f = q_y_rows * w_oth + fxw
    flat_c = q_y_rows * w_oth + cxw

    oth_flat = oth_img.reshape(-1, 3).astype(jnp.float32)
    i_floor = jnp.take(oth_flat, flat_f, axis=0)
    i_ceil = jnp.take(oth_flat, flat_c, axis=0)
    lerp = floor_wgt[..., None] * i_floor + (1.0 - floor_wgt[..., None]) * i_ceil
    clr = jnp.mean(jnp.abs(q_img.astype(jnp.float32) - lerp), axis=-1)

    grd_flat = oth_grd.reshape(-1)
    g_floor = jnp.take(grd_flat, flat_f, axis=0)
    g_ceil = jnp.take(grd_flat, flat_c, axis=0)
    g_lerp = floor_wgt * g_floor + (1.0 - floor_wgt) * g_ceil
    grd = jnp.abs(q_grd - g_lerp)

    return (alpha * jnp.minimum(clr, tau_clr)
            + (1.0 - alpha) * jnp.minimum(grd, tau_grd))


def grd_fly_cost(ref_bgr: jax.Array, oth_bgr: jax.Array, ref_grd: jax.Array,
                 oth_grd: jax.Array, abc: jax.Array, *, sign: int,
                 half_wnd: int, max_dis: int, gamma: float,
                 alpha: float = 0.1, tau_clr: float = 10.0,
                 tau_grd: float = 2.0,
                 ref_wgt: jax.Array | None = None) -> jax.Array:
    """Single-scale GrdPC cost for K candidate plane fields.

    Args:
      ref_bgr / oth_bgr: u8[H, W, 3] this/other view.
      ref_grd / oth_grd: f32[H, W] gray_gradient of each view.
      abc: f32[K, H, W, 3]; sign: -1 for the left view, +1 for the right
        (other_x = q_x + (2*view - 1)*dq, grd_pc.cc:149).
      ref_wgt: optional u8[H, W, 3] image the ASW weights are computed
        on instead of ref_bgr -- pass the Lab conversion for the
        reference's USE_LAB_WGT variant (grd_pc.cc:80-110; the data term
        stays BGR/gradient either way).

    Returns:
      f32[K, H, W].
    """
    h, w, _ = ref_bgr.shape
    k = abc.shape[0]
    wnd = 2 * half_wnd + 1
    img_i32 = (ref_bgr if ref_wgt is None else ref_wgt).astype(jnp.int32)
    inv_gamma = jnp.float32(1.0 / gamma)
    sat = jnp.float32(alpha * tau_clr + (1.0 - alpha) * tau_grd)

    ys_c = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs_c = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    d_f = abc[..., 0] * xs_c + abc[..., 1] * ys_c + abc[..., 2]
    a_f, b_f = abc[..., 0], abc[..., 1]

    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)

    def body(o, acc):
        dy = o // wnd - half_wnd
        dx = o % wnd - half_wnd
        # roll per-center fields to the q = c + (dy, dx) frame
        dq = jnp.roll(d_f + a_f * dx + b_f * dy, (dy, dx), axis=(-2, -1))
        c_img = jnp.roll(img_i32, (dy, dx), axis=(0, 1))
        cy = ys - dy
        cx = xs - dx
        m = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)

        l1 = jnp.sum(jnp.abs(c_img - img_i32), axis=-1).astype(jnp.float32)
        wgt = jnp.exp(-l1 * inv_gamma)

        f = _trunc(dq)
        ok = (f > 0) & (f < max_dis)
        dq_safe = jnp.where(ok, dq, 1.0)
        val = _data_term(ref_bgr[None], ref_grd[None], oth_bgr, oth_grd,
                         dq_safe, xs[None], ys[None] * 1, sign,
                         w_oth=w, alpha=alpha, tau_clr=tau_clr,
                         tau_grd=tau_grd)
        val = jnp.where(ok, val, sat)
        contrib = jnp.where(m, wgt * val, 0.0)
        return acc + jnp.roll(contrib, (-dy, -dx), axis=(-2, -1))

    acc0 = jnp.zeros((k, h, w), jnp.float32) + 0.0 * d_f
    return jax.lax.fori_loop(0, wnd * wnd, body, acc0)


def cs_fly_cost(pyr_bgr_ref: Sequence[jax.Array],
                pyr_bgr_oth: Sequence[jax.Array],
                pyr_grd_ref: Sequence[jax.Array],
                pyr_grd_oth: Sequence[jax.Array],
                scale_wgts: Sequence[float], abc0: jax.Array, *, sign: int,
                half_wnd: int, max_dis: int, gamma: float,
                alpha: float = 0.1, tau_clr: float = 10.0,
                tau_grd: float = 2.0,
                pyr_wgt_ref: Sequence[jax.Array] | None = None) -> jax.Array:
    """Cross-scale on-the-fly cost (CSPC, cspc.cc:107-182).

    Level s > 0 re-anchors each fine pixel's plane through
    ((x >> s), (y >> s), d/2^s) and evaluates the unscaled window on the
    level-s images, warping into the level-s other view; level costs sum
    with the inter-scale weights.  Uses the same upsample-with-margin
    trick as ops.plane_cost.window_plane_cost_upsampled.

    pyr_wgt_ref: optional per-level u8[Hs, Ws, 3] weight images (the
    per-level Lab conversions for USE_LAB_WGT, cspc.cc:48-49,185-195);
    defaults to the BGR levels.
    """
    h, w, _ = pyr_bgr_ref[0].shape
    k = abc0.shape[0]
    wnd = 2 * half_wnd + 1
    inv_gamma = jnp.float32(1.0 / gamma)
    sat = jnp.float32(alpha * tau_clr + (1.0 - alpha) * tau_grd)

    total = None
    md = max_dis
    for s in range(len(scale_wgts)):
        if s == 0:
            cost_s = grd_fly_cost(pyr_bgr_ref[0], pyr_bgr_oth[0],
                                  pyr_grd_ref[0], pyr_grd_oth[0], abc0,
                                  sign=sign, half_wnd=half_wnd, max_dis=md,
                                  gamma=gamma, alpha=alpha, tau_clr=tau_clr,
                                  tau_grd=tau_grd,
                                  ref_wgt=(None if pyr_wgt_ref is None
                                           else pyr_wgt_ref[0]))
        else:
            hs, ws = pyr_bgr_ref[s].shape[:2]
            step = 1 << s
            m = half_wnd * step
            img_up = upsample_level(pyr_bgr_ref[s], s, half_wnd, (h, w))
            grd_up = upsample_level(pyr_grd_ref[s], s, half_wnd, (h, w))
            valid_up = upsample_valid(s, half_wnd, (h, w), (hs, ws))
            wgt_up = (img_up if pyr_wgt_ref is None else
                      upsample_level(pyr_wgt_ref[s], s, half_wnd, (h, w)))
            img_i32 = wgt_up.astype(jnp.int32)

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
            ysp = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 0)
            xsp = jax.lax.broadcasted_iota(jnp.int32, (hp, wp), 1)
            # coarse coords of each padded-fine position (clamped; margins
            # are masked by valid_up)
            q_ys = jnp.clip((ysp - m) >> s, 0, hs - 1)
            q_xs = jnp.clip((xsp - m) >> s, 0, ws - 1)

            def body(o, acc, img_i32=img_i32, grd_up=grd_up,
                     valid_up=valid_up, a_f=a_f, b_f=b_f, d_f=d_f,
                     q_ys=q_ys, q_xs=q_xs, ysp=ysp, xsp=xsp, s=s,
                     hs=hs, ws=ws, md_s=md, oth=pyr_bgr_oth[s],
                     oth_g=pyr_grd_oth[s], step=step, m=m):
                dy = o // wnd - half_wnd
                dx = o % wnd - half_wnd
                sy = dy * step
                sx = dx * step
                dq = jnp.roll(d_f + a_f * dx + b_f * dy, (sy, sx),
                              axis=(-2, -1))
                c_img = jnp.roll(img_i32, (sy, sx), axis=(0, 1))
                c_ok = ((ysp - sy >= m) & (ysp - sy < m + h)
                        & (xsp - sx >= m) & (xsp - sx < m + w))
                mask = c_ok & valid_up

                l1 = jnp.sum(jnp.abs(c_img - img_i32),
                             axis=-1).astype(jnp.float32)
                wgt = jnp.exp(-l1 * inv_gamma)

                f = _trunc(dq)
                ok = (f > 0) & (f < md_s)
                dq_safe = jnp.where(ok, dq, 1.0)
                val = _data_term(
                    img_up[None], grd_up[None], oth, oth_g, dq_safe,
                    q_xs[None], q_ys[None] * 1, sign, w_oth=ws,
                    alpha=alpha, tau_clr=tau_clr, tau_grd=tau_grd)
                val = jnp.where(ok, val, sat)
                contrib = jnp.where(mask, wgt * val, 0.0)
                return acc + jnp.roll(contrib, (-sy, -sx), axis=(-2, -1))

            acc0 = jnp.zeros((k, hp, wp), jnp.float32) + 0.0 * d_f
            acc = jax.lax.fori_loop(0, wnd * wnd, body, acc0)
            cost_s = acc[:, m:m + h, m:m + w]
        term = jnp.float32(scale_wgts[s]) * cost_s
        total = term if total is None else total + term
        md //= 2
    return total
