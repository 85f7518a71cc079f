"""Fused GPU kernel (Pallas on Triton) for the slanted-plane ASW window cost.

This is the engine's hot path (SURVEY.md section 3.5): every exact plane-cost
evaluation is a 35x35 adaptive-support-weight window sum over a disparity
volume with a per-window-pixel linear interpolation between two slices
(pre_ss_pc.cc:74-118).  The jnp authority (ops.plane_cost.window_plane_cost)
walks the window offsets in a fori_loop whose every step rolls the [K, H, W]
plane fields, gathers two volume taps and reads and writes the [K, H, W]
accumulator in device memory.

Here one program owns a (view, pixel tile) and loops over the window offsets
itself, so:
  * the K candidate accumulators stay in registers over all offsets;
  * the ASW weight exp(-L1/gamma) is computed once per offset and shared by
    the K candidates;
  * the two lerp taps are read by gather from a [D, H, W] volume, where
    neighbouring pixels of a smooth plane field read neighbouring addresses.

Semantics match ops.plane_cost.window_plane_cost (and, for scale > 0,
window_plane_cost_upsampled): the same window offsets in the same order, the
same C-trunc in-range test f in [1, max_dis-1], the same saturation to the
per-view max cost, and plane disparities associated in the same order.
Cross-scale levels are indexed directly at ((y + oy) >> s, (x + ox) >> s)
instead of through nearest-upsampled copies.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Pixel tile per program and warps per program (powers of two; the fastest
# of the tiles swept on an H100, see PERF.md).
TILE_H = 8
TILE_W = 32
NUM_WARPS = 4


class Prepared(NamedTuple):
    """Kernel layout of one pyramid level's per-view data, built once per
    pair (not per evaluation).

    img: i32[2, Hi, Wi] -- the three u8 weight-image channels packed as
      c0 | c1 << 8 | c2 << 16 (one load per window pixel).
    vol: [2, D, Hi, Wi] -- the cost volume with disparity outermost, in the
      storage dtype the kernel reads (f32 or bf16).
    """

    img: jax.Array
    vol: jax.Array


def prepare(imgs_u8: jax.Array, vols: jax.Array,
            vol_dtype=jnp.float32) -> Prepared:
    """Lay out u8[2, Hi, Wi, 3] weight images and [2, Hi, Wi, D] volumes."""
    c = imgs_u8.astype(jnp.int32)
    img = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
    vol = jnp.moveaxis(vols.astype(vol_dtype), -1, 1)
    return Prepared(img, vol)


def plane_params(abc: jax.Array) -> jax.Array:
    """f32[2, K, H, W, 3] planes -> f32[2, K, 3, H, W] (d_center, a, b).

    d_center is the plane disparity at the pixel's own output coordinates,
    computed exactly as ops.plane_cost.window_plane_cost does.
    """
    h, w = abc.shape[-3], abc.shape[-2]
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    d_center = abc[..., 0] * xs + abc[..., 1] * ys + abc[..., 2]
    return jnp.stack([d_center, abc[..., 0], abc[..., 1]], axis=2)


def _kernel(meta_ref, maxc_ref, img_ref, vol_ref, prm_ref, out_ref, *,
            th: int, tw: int, n_k: int, half_wnd: int, stride: int,
            scale: int, max_dis: int, inv_gamma: float, h: int, w: int,
            hi: int, wi: int, d: int):
    """One (view, tile row, tile column) program.

    meta_ref: i32[6] (oy, ox, ylo, yhi, xlo, xhi): output pixel (y, x) is
      centred at array position ((y + oy) >> scale, (x + ox) >> scale); a
      window pixel counts iff its array row is in [ylo, yhi) and its column
      in [xlo, xhi) (already clipped to the array).
    maxc_ref: f32[2] per-view saturation values.
    img_ref: i32[2*Hi*Wi], vol_ref: [2*D*Hi*Wi], prm_ref: f32[2*K*3*H*W],
      out_ref: f32[2*K*Hp*Wp], the output padded to whole tiles -- all
      flat, indexed by computed offsets.
    """
    v = pl.program_id(0)
    ys = (pl.program_id(1) * th
          + jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0))
    xs = (pl.program_id(2) * tw
          + jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1))
    # edge tiles: parameter reads clamp to the image, and the output is
    # padded to whole tiles, so no lane writes another lane's pixel
    pix = jnp.minimum(ys, h - 1) * w + jnp.minimum(xs, w - 1)
    hp, wp = pl.num_programs(1) * th, pl.num_programs(2) * tw
    oy, ox = meta_ref[0], meta_ref[1]
    ylo, yhi, xlo, xhi = meta_ref[2], meta_ref[3], meta_ref[4], meta_ref[5]
    maxc = maxc_ref[v]
    hw_a = hi * wi

    cy = (ys + oy) >> scale
    cx = (xs + ox) >> scale
    img_base = v * hw_a
    ctr = img_ref[img_base + jnp.clip(cy, 0, hi - 1) * wi
                  + jnp.clip(cx, 0, wi - 1)]
    ctr_ch = [(ctr >> (8 * c)) & 255 for c in range(3)]

    p0, pa, pb = [], [], []
    for k in range(n_k):
        base = (v * n_k + k) * 3 * h * w + pix
        d_c = prm_ref[base]
        p0.append(d_c * (1.0 / (1 << scale)) if scale else d_c)
        pa.append(prm_ref[base + h * w])
        pb.append(prm_ref[base + 2 * h * w])

    vol_base = v * d * hw_a
    n_off = len(range(-half_wnd, half_wnd + 1, stride))

    def dy_body(i, accs):
        dy = i * stride - half_wnd
        dyf = dy.astype(jnp.float32)
        qy = cy + dy
        y_ok = (qy >= ylo) & (qy < yhi)
        row = jnp.clip(qy, 0, hi - 1) * wi

        def dx_body(j, accs):
            dx = j * stride - half_wnd
            dxf = dx.astype(jnp.float32)
            qx = cx + dx
            q_ok = y_ok & (qx >= xlo) & (qx < xhi)
            qoff = row + jnp.clip(qx, 0, wi - 1)
            qp = img_ref[img_base + qoff]
            l1 = (jnp.abs(ctr_ch[0] - (qp & 255))
                  + jnp.abs(ctr_ch[1] - ((qp >> 8) & 255))
                  + jnp.abs(ctr_ch[2] - ((qp >> 16) & 255)))
            wgt = jnp.where(q_ok,
                            jnp.exp(-l1.astype(jnp.float32) * inv_gamma),
                            0.0)
            out = []
            for k in range(n_k):
                dq = p0[k] + pa[k] * dxf + pb[k] * dyf
                f = jnp.trunc(dq)
                in_rng = (f >= 1.0) & (f <= float(max_dis - 1))
                fi = jnp.clip(f, 0.0, float(max(max_dis - 1, 0))).astype(
                    jnp.int32)
                vidx = vol_base + fi * hw_a + qoff
                take = in_rng & q_ok
                v_f = plgpu.load(vol_ref.at[vidx], mask=take,
                                 other=0).astype(jnp.float32)
                v_c = plgpu.load(vol_ref.at[vidx + hw_a], mask=take,
                                 other=0).astype(jnp.float32)
                fw = (fi + 1).astype(jnp.float32) - dq
                val = jnp.where(in_rng, fw * v_f + (1.0 - fw) * v_c, maxc)
                out.append(accs[k] + wgt * val)
            return tuple(out)

        return jax.lax.fori_loop(0, n_off, dx_body, accs)

    accs = tuple(jnp.zeros((th, tw), jnp.float32) for _ in range(n_k))
    accs = jax.lax.fori_loop(0, n_off, dy_body, accs)
    for k in range(n_k):
        out_ref[((v * n_k + k) * hp + ys) * wp + xs] = accs[k]


def _launch(prep: Prepared, max_costs: jax.Array, params: jax.Array, *,
            half_wnd: int, max_dis: int, gamma: float, wnd_stride: int,
            scale: int, origin: Sequence, bounds: jax.Array | None,
            interpret: bool) -> jax.Array:
    """One kernel launch over both views of one pyramid level.

    params: plane_params() output, f32[2, K, 3, H, W], on the fine output
    grid.  Returns f32[2, K, H, W].
    """
    _, n_k, _, h, w = params.shape
    _, d, hi, wi = prep.vol.shape
    full = jnp.array([0, hi, 0, wi], jnp.int32)
    bounds = full if bounds is None else jnp.asarray(bounds, jnp.int32)
    lo = jnp.maximum(bounds[0::2], 0)
    hi_b = jnp.minimum(bounds[1::2], full[1::2])
    meta = jnp.stack([jnp.asarray(origin[0], jnp.int32),
                      jnp.asarray(origin[1], jnp.int32),
                      lo[0], hi_b[0], lo[1], hi_b[1]])
    th, tw = TILE_H, TILE_W
    n_ty, n_tx = -(-h // th), -(-w // tw)
    kern = functools.partial(
        _kernel, th=th, tw=tw, n_k=n_k, half_wnd=half_wnd,
        stride=wnd_stride, scale=scale, max_dis=max_dis,
        inv_gamma=1.0 / gamma, h=h, w=w, hi=hi, wi=wi, d=d)
    out = pl.pallas_call(
        kern,
        grid=(2, n_ty, n_tx),
        out_shape=jax.ShapeDtypeStruct((2 * n_k * n_ty * th * n_tx * tw,),
                                       jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=f"window_cost_s{scale}",
    )(meta, jnp.asarray(max_costs, jnp.float32), prep.img.reshape(-1),
      prep.vol.reshape(-1), params.reshape(-1))
    return out.reshape(2, n_k, n_ty * th, n_tx * tw)[:, :, :h, :w]


def window_cost_prepared(prep: Prepared, max_costs: jax.Array,
                         abc: jax.Array, *, half_wnd: int, max_dis: int,
                         gamma: float, wnd_stride: int = 1,
                         origin: Sequence = (0, 0),
                         bounds: jax.Array | None = None,
                         interpret: bool = False) -> jax.Array:
    """Single-scale window cost of K candidate planes per pixel, both views.

    Args:
      prep: prepare() output (fine level).
      max_costs: f32[2] per-view saturation values.
      abc: f32[2, K, H, W, 3] candidate planes on the output grid.
      wnd_stride: evaluate every wnd_stride-th window offset per axis (the
        strided prescreen; 1 for true costs).
      origin: (oy, ox), ints or traced scalars: output pixel (y, x) centres
        its window at array position (y + oy, x + ox) -- a sharded caller
        passes its halo depth.
      bounds: optional i32[4] [ylo, yhi, xlo, xhi) array rows/columns that
        hold real image pixels (neighbour-halo rows of a sharded block
        count, rows past the global image border do not); defaults to the
        whole array.
      interpret: run the Pallas interpreter (CPU tests only).

    Returns:
      f32[2, K, H, W]; semantics of ops.plane_cost.window_plane_cost
      vmapped over views.
    """
    return _launch(prep, max_costs, plane_params(abc), half_wnd=half_wnd,
                   max_dis=max_dis, gamma=gamma, wnd_stride=wnd_stride,
                   scale=0, origin=origin, bounds=bounds,
                   interpret=interpret)


def cross_scale_cost_prepared(preps: Sequence[Prepared],
                              max_costs_s: Sequence[jax.Array],
                              scale_wgts: Sequence[float], abc: jax.Array, *,
                              half_wnd: int, max_dis: int, gamma: float,
                              origins: Sequence | None = None,
                              bounds_s: Sequence | None = None,
                              interpret: bool = False) -> jax.Array:
    """sum_s wgt_s * cost_s over the pyramid, one kernel launch per level.

    The plane is re-anchored through the level-s point
    ((y + oy) >> s, (x + ox) >> s, d / 2^s) (pre_cs_pc.cc:133-188); same
    semantics as ops.plane_cost.cross_scale_plane_cost vmapped over views.
    origins / bounds_s give each level's origin and bounds (see
    window_cost_prepared; defaults (0, 0) and the whole level).  A sharded
    caller passes its halo depth at level 0 and its block's global offset
    at the coarse levels, which it holds whole.
    """
    params = plane_params(abc)
    total = None
    md = max_dis
    for s, prep in enumerate(preps):
        cost_s = _launch(
            prep, max_costs_s[s], params, half_wnd=half_wnd, max_dis=md,
            gamma=gamma, wnd_stride=1, scale=s,
            origin=(0, 0) if origins is None else origins[s],
            bounds=None if bounds_s is None else bounds_s[s],
            interpret=interpret)
        term = jnp.float32(scale_wgts[s]) * cost_s
        total = term if total is None else total + term
        md //= 2
    return total
