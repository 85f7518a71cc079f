"""Disparity post-processing: LR consistency check, invalid fill, weighted
median (cs_patchmatch.cc:508-588).

All three stages are restructured as dense array programs:
  * LR check (cs_patchmatch.cc:347-369): per-pixel gather of the other
    view's disparity at the warped column.
  * FillInvalid (cs_patchmatch.cc:370-428): the per-row nearest-valid-left/
    right searches become prefix/suffix cummax scans; the chosen pixels'
    *planes* are extrapolated at the filled pixel.
  * WeightedMedian (cs_patchmatch.cc:430-506): the reference builds a 256-bin
    color-weighted histogram per invalid pixel and scans for the weighted
    median.  Here the same median -- the smallest d whose cumulative weight
    reaches half the total -- is found by an 8-step binary search over d,
    each step a dense windowed masked sum; this avoids per-pixel
    scatter-into-histogram, which does not vectorize.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import CSPMConfig
from ..ops import plane


def lr_check(dis: jax.Array, cfg: CSPMConfig) -> jax.Array:
    """valid[v,y,x] = 1 iff |d_v(x) - d_other(x -+ round(d_v))| <= 0.5 and
    d_v > 0, with out-of-range warps invalid (cs_patchmatch.cc:347-369).

    Args:
      dis: u8[2, H, W] scaled disparity maps.

    Returns:
      bool[2, H, W].
    """
    _, h, w = dis.shape
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    d = dis.astype(jnp.float32) / cfg.dis_scale

    def per_view(dv, d_other, sign):
        other_x = xs + sign * jnp.rint(dv).astype(jnp.int32)
        in_range = (other_x >= 0) & (other_x < w)
        other = jnp.take_along_axis(d_other,
                                    jnp.clip(other_x, 0, w - 1), axis=1)
        return in_range & (jnp.abs(dv - other) <= cfg.lr_check_thres) & (dv > 0)

    valid_l = per_view(d[0], d[1], -1)
    valid_r = per_view(d[1], d[0], +1)
    return jnp.stack([valid_l, valid_r])


def fill_invalid(dis: jax.Array, abc: jax.Array, valid: jax.Array,
                 cfg: CSPMConfig) -> jax.Array:
    """Background fill of invalid pixels from the nearest valid pixels' planes
    (cs_patchmatch.cc:370-428).

    For each invalid pixel: find the nearest valid pixel to the left and to
    the right in the same row, extrapolate *their planes* at this x, and take
    the smaller disparity; one-sided if only one side exists, unchanged if
    neither.  Output quantization: saturate(dis_scale * round(d)).
    """
    two, h, w = dis.shape
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)

    def per_view(dis_v, abc_v, valid_v):
        # nearest valid index to the left (inclusive): prefix cummax of
        # (x if valid else -1); to the right: suffix "cummin" via reversal.
        lidx = jax.lax.cummax(jnp.where(valid_v, xs, -1), axis=1)
        ridx_rev = jax.lax.cummax(
            jnp.where(valid_v, w - 1 - xs, -1)[:, ::-1], axis=1)[:, ::-1]
        ridx = jnp.where(ridx_rev >= 0, w - 1 - ridx_rev, w)
        l_ok = lidx >= 0
        r_ok = ridx < w

        l_abc = jnp.take_along_axis(abc_v, jnp.clip(lidx, 0, w - 1)[..., None],
                                    axis=1)
        r_abc = jnp.take_along_axis(abc_v, jnp.clip(ridx, 0, w - 1)[..., None],
                                    axis=1)
        xf = xs.astype(jnp.float32)
        l_d = plane.disparity_at(l_abc, xf, ys)
        r_d = plane.disparity_at(r_abc, xf, ys)

        both = l_ok & r_ok
        d_fill = jnp.where(both, jnp.minimum(l_d, r_d),
                           jnp.where(l_ok, l_d, r_d))
        fill_u8 = jnp.clip(cfg.dis_scale * jnp.rint(d_fill), 0,
                           255).astype(jnp.uint8)
        do_fill = (~valid_v) & (l_ok | r_ok)
        return jnp.where(do_fill, fill_u8, dis_v)

    return jnp.stack([per_view(dis[v], abc[v], valid[v]) for v in range(2)])


def weighted_median(dis: jax.Array, imgs: jax.Array, valid: jax.Array,
                    cfg: CSPMConfig, center_row0: int = 0,
                    out_h: int | None = None, center_col0: int = 0,
                    out_w: int | None = None) -> jax.Array:
    """Color-weighted median of valid window disparities, applied at invalid
    pixels only (cs_patchmatch.cc:430-506).

    The reference's per-pixel 256-bin weighted histogram scan selects the
    smallest d with cumsum(d) >= total/2; a monotone binary search over d
    computes exactly that with 8 dense passes.

    Args:
      dis / imgs / valid: u8[2, Ha, Wa] / u8[2, Ha, Wa, 3] / bool[2, Ha, Wa].
        Ha/Wa may exceed the output extent when the caller pre-extends
        rows/columns with shard halos (pixels past the global border must
        carry valid=0, which zero-weights them exactly like out-of-image
        window pixels).
      center_row0 / center_col0: array position of output pixel (0, 0)
        (halo depth; 0 single-device).
      out_h / out_w: output extent (defaults to Ha / Wa).

    Returns:
      u8[2, out_h, out_w].
    """
    two, ha, wa = dis.shape
    h = out_h if out_h is not None else ha
    w = out_w if out_w is not None else wa
    half_wnd = cfg.wnd_size // 2
    wnd = cfg.wnd_size
    inv_gamma = jnp.float32(1.0 / cfg.wmf_gamma)

    def window_sum(center_img, img_pad, dis_pad, valid_pad, thresh):
        """sum over window of w(p,q) * valid_q * [disp_q <= thresh_p],
        plus the unconditional weighted total."""

        def body(o, accs):
            acc_thr, acc_tot = accs
            dy = o // wnd - half_wnd
            dx = o % wnd - half_wnd
            start = (center_row0 + dy + half_wnd,
                     center_col0 + dx + half_wnd)
            q_img = jax.lax.dynamic_slice(img_pad, (*start, 0), (h, w, 3))
            q_dis = jax.lax.dynamic_slice(dis_pad, start, (h, w))
            q_val = jax.lax.dynamic_slice(valid_pad, start, (h, w))
            l1 = jnp.sum(jnp.abs(center_img - q_img),
                         axis=-1).astype(jnp.float32)
            wgt = jnp.exp(-l1 * inv_gamma) * q_val
            acc_tot = acc_tot + wgt
            acc_thr = acc_thr + wgt * (q_dis <= thresh)
            return acc_thr, acc_tot

        # derive from thresh so loop-carry sharding metadata matches
        z = thresh * jnp.float32(0.0)
        return jax.lax.fori_loop(0, wnd * wnd, body, (z, z))

    def per_view(dis_v, img_v, valid_v):
        img_i32 = img_v.astype(jnp.int32)
        img_pad = jnp.pad(img_i32, ((half_wnd,) * 2, (half_wnd,) * 2, (0, 0)))
        dis_pad = jnp.pad(dis_v.astype(jnp.int32), half_wnd)
        # pad valid with 0 so out-of-image window pixels contribute nothing
        valid_pad = jnp.pad(valid_v.astype(jnp.float32), half_wnd)
        def out_block(x):
            x = jax.lax.slice_in_dim(x, center_row0, center_row0 + h,
                                     axis=0)
            return jax.lax.slice_in_dim(x, center_col0, center_col0 + w,
                                        axis=1)

        center_img = out_block(img_i32)
        dis_out = out_block(dis_v)
        valid_out = out_block(valid_v)

        zero = (dis_out * 0).astype(jnp.int32)
        # total weight (threshold 255 includes everything valid)
        _, total = window_sum(center_img, img_pad, dis_pad, valid_pad,
                              zero + 255)
        half_total = total * 0.5

        lo = zero
        hi = zero + 255

        def search_step(_, lohi):
            lo, hi = lohi
            mid = (lo + hi) >> 1
            s, _ = window_sum(center_img, img_pad, dis_pad, valid_pad, mid)
            ge = s >= half_total
            return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)

        lo, hi = jax.lax.fori_loop(0, 8, search_step, (lo, hi))
        median = lo.astype(jnp.uint8)
        replace = (~valid_out) & (half_total > 0)
        return jnp.where(replace, median, dis_out)

    return jnp.stack([per_view(dis[v], imgs[v], valid[v]) for v in range(2)])


def postprocess(dis: jax.Array, abc: jax.Array, imgs: jax.Array,
                cfg: CSPMConfig) -> Tuple[jax.Array, jax.Array]:
    """Full pipeline: LR check -> fill -> weighted median
    (cs_patchmatch.cc:508-588).

    Returns (dis, valid): the cleaned maps and the LR-check validity mask.
    """
    valid = lr_check(dis, cfg)
    dis = fill_invalid(dis, abc, valid, cfg)
    dis = weighted_median(dis, imgs, valid, cfg)
    return dis, valid
