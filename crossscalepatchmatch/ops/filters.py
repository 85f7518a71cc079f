"""Cost-volume aggregation filters + constant-median capability.

Covers the reference's filter-based aggregation surface (CAMethod,
ca_method.h:24; BoxCA/GFCA/BFCA, ca_filter/*.cpp) and the constant-time
median filter capability (ctmf.c via MedianFilter, commfunc.cc:11-25).

Semantics reproduced:
  * BoxFilter (ca_filter/GuidedFilter.cpp:47-100): *truncated-window raw
    sums* -- out(y,x) = sum of src over the window clipped to the image, NO
    normalization.  O(1) per pixel via cumulative sums; here each axis is a
    cumsum + two clipped gathers, which XLA fuses into a bandwidth-bound
    pass (the dense analogue of the reference's CumSum two-pass scheme).
  * GuidedFilter (ca_filter/GuidedFilter.cpp:109-277): He et al. with
    N = BoxFilter(ones) normalization; gray guidance closed form and color
    guidance with the hand-unrolled regularized 3x3 inverse (the FAST_INV
    path, GuidedFilter.cpp:223-255).  Defaults r=9, eps=1e-4
    (GuidedFilter.h:24).
  * BilateralFilter (ca_filter/BilateralFilter.cpp:3-95): joint bilateral
    with WRAP-AROUND window borders (qy/qx wrapped by +-H/W, matching
    jnp.roll exactly), sig_sp = wnd/2, weight
    exp(-(dx^2+dy^2)/sig_sp^2 - clr^2/sig_clr^2) where clr is the
    mean-abs-channel-diff for color guides; default sig_clr=0.03
    (BilateralFilter.h:5).
  * Aggregators (BoxCA.cpp:8-12, GFCA.cpp:8-11, BFCA.cpp:9-12): filter
    slices d = 1 .. max_dis-1 ONLY (slice 0 and slice max_dis pass
    through); box radius 3 (7x7), guided r=9, bilateral wnd=35.
  * Median (ctmf.c:378-433 capability): (2r+1)^2 window median of a u8
    image with replicate borders, found by an 8-step binary search over
    intensity -- each step one dense box-count -- instead of the
    reference's per-column histograms (scatter-free, so it vectorizes).

The reference applies these filters to f64 volumes built from [0,1]-scaled
images in its parent project; this module takes f32 volumes and u8 guides
and normalizes guides to [0,1] internally for GF/BF so the eps/sig_clr
constants keep their published meaning.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def box_filter(x: jax.Array, radius: int) -> jax.Array:
    """Truncated-window box sum over the last two axes.

    out[..., y, x] = sum of x over rows [y-r, y+r] and cols [x-r, x+r]
    clipped to the array (GuidedFilter.cpp:47-100).
    """

    def along(v: jax.Array, axis: int) -> jax.Array:
        v = jnp.moveaxis(v, axis, -1)
        n = v.shape[-1]
        c = jnp.cumsum(v, axis=-1)
        idx = jnp.arange(n)
        hi = c[..., jnp.clip(idx + radius, 0, n - 1)]
        lo = jnp.where(idx - radius - 1 < 0, 0,
                       c[..., jnp.clip(idx - radius - 1, 0, n - 1)])
        return jnp.moveaxis(hi - lo, -1, axis)

    return along(along(x, -2), -1)


def box_count(hw: tuple, radius: int, dtype=jnp.float32) -> jax.Array:
    """N = BoxFilter(ones): per-pixel clipped-window pixel count."""
    return box_filter(jnp.ones(hw, dtype), radius)


def guided_filter(guide: jax.Array, p: jax.Array, radius: int = 9,
                  eps: float = 1e-4) -> jax.Array:
    """He et al. guided filter of a single-channel signal.

    Args:
      guide: f32[H, W] (gray guidance, GuidedFilter.cpp:117-146) or
        f32[H, W, 3] (color guidance with the FAST_INV 3x3 closed-form
        inverse, GuidedFilter.cpp:146-275); expected range [0, 1].
      p: f32[H, W] filtering input.
    """
    hw = p.shape
    n = box_count(hw, radius, p.dtype)
    bf = lambda v: box_filter(v, radius) / n
    mean_p = bf(p)

    if guide.ndim == 2:
        mean_i = bf(guide)
        cov_ip = bf(guide * p) - mean_i * mean_p
        var_i = bf(guide * guide) - mean_i * mean_i
        a = cov_ip / (var_i + eps)
        b = mean_p - a * mean_i
        return bf(a) * guide + bf(b)

    chans = [guide[..., c] for c in range(3)]
    mean_i = [bf(c) for c in chans]
    cov_ip = [bf(chans[c] * p) - mean_i[c] * mean_p for c in range(3)]
    # upper-triangular covariance entries rr, rg, rb, gg, gb, bb
    var = {}
    for c in range(3):
        for cp in range(c, 3):
            var[(c, cp)] = (bf(chans[c] * chans[cp])
                            - mean_i[c] * mean_i[cp])
    a11 = var[(0, 0)] + eps
    a12, a13 = var[(0, 1)], var[(0, 2)]
    a22 = var[(1, 1)] + eps
    a23 = var[(1, 2)]
    a33 = var[(2, 2)] + eps
    det = (a11 * (a33 * a22 - a23 * a23)
           - a12 * (a33 * a12 - a23 * a13)
           + a13 * (a23 * a12 - a22 * a13))
    inv_det = 1.0 / det
    c0, c1, c2 = cov_ip
    a = [inv_det * (c0 * (a33 * a22 - a23 * a23)
                    + c1 * (a13 * a23 - a33 * a12)
                    + c2 * (a23 * a12 - a13 * a22)),
         inv_det * (c0 * (a23 * a13 - a33 * a12)
                    + c1 * (a33 * a11 - a13 * a13)
                    + c2 * (a13 * a12 - a23 * a11)),
         inv_det * (c0 * (a23 * a12 - a22 * a13)
                    + c1 * (a12 * a13 - a23 * a11)
                    + c2 * (a22 * a11 - a12 * a12))]
    b = mean_p - sum(a[c] * mean_i[c] for c in range(3))
    q = box_filter(b, radius)
    for c in range(3):
        q = q + box_filter(a[c], radius) * chans[c]
    return q / n


def bilateral_filter(guide: jax.Array, p: jax.Array, wnd: int,
                     sig_clr: float = 0.03) -> jax.Array:
    """Joint bilateral filter with wrap-around borders
    (BilateralFilter.cpp:3-95; sig_sp = wnd/2 per :11).

    Args:
      guide: f32[H, W] or f32[H, W, 3], range [0, 1].
      p: f32[H, W].
    """
    half = wnd // 2
    sig_sp = wnd / 2.0
    inv_sp2 = jnp.float32(1.0 / (sig_sp * sig_sp))
    inv_clr2 = jnp.float32(1.0 / (sig_clr * sig_clr))
    color = guide.ndim == 3
    roll_axes = (0, 1)

    def body(o, accs):
        s, sw = accs
        dy = o // wnd - half
        dx = o % wnd - half
        q_guide = jnp.roll(guide, (-dy, -dx), axis=roll_axes)
        q_p = jnp.roll(p, (-dy, -dx), axis=(0, 1))
        if color:
            clr = jnp.mean(jnp.abs(q_guide - guide), axis=-1)
        else:
            clr = jnp.abs(q_guide - guide)
        sp = jnp.float32(dx * dx + dy * dy)
        wgt = jnp.exp(-sp * inv_sp2 - clr * clr * inv_clr2)
        return s + wgt * q_p, sw + wgt

    s0 = jnp.zeros_like(p)
    s, sw = jax.lax.fori_loop(0, wnd * wnd, body, (s0, s0))
    return s / sw


def _filter_inner_slices(vol: jax.Array, fn) -> jax.Array:
    """Apply fn to slices 1..D-2, passing through 0 and D-1 (the aggreCV
    loop bounds d = 1 .. maxDis-1 of BoxCA/GFCA/BFCA.cpp)."""
    d = vol.shape[-1]
    if d <= 2:
        return vol
    inner = jnp.moveaxis(vol[..., 1:d - 1], -1, 0)
    inner = jax.vmap(fn)(inner)
    return jnp.concatenate(
        [vol[..., :1], jnp.moveaxis(inner, 0, -1), vol[..., d - 1:]], axis=-1)


def box_filter_volume(vol: jax.Array, radius: int = 3) -> jax.Array:
    """BoxCA: 7x7 box-sum each inner slice (BoxCA.cpp:8-12)."""
    return _filter_inner_slices(vol, functools.partial(box_filter,
                                                       radius=radius))


def guided_filter_volume(vol: jax.Array, guide_u8: jax.Array,
                         radius: int = 9, eps: float = 1e-4) -> jax.Array:
    """GFCA: guided-filter each inner slice, color guidance from the left
    view (GFCA.cpp:8-11)."""
    guide = guide_u8.astype(vol.dtype) / 255.0
    return _filter_inner_slices(
        vol, functools.partial(guided_filter, guide, radius=radius, eps=eps))


def bilateral_filter_volume(vol: jax.Array, guide_u8: jax.Array,
                            wnd: int = 35,
                            sig_clr: float = 0.03) -> jax.Array:
    """BFCA: 35x35 joint-bilateral each inner slice (BFCA.cpp:9-12)."""
    guide = guide_u8.astype(vol.dtype) / 255.0
    return _filter_inner_slices(
        vol, functools.partial(bilateral_filter, guide, wnd=wnd,
                               sig_clr=sig_clr))


def median_filter_u8(img: jax.Array, radius: int) -> jax.Array:
    """(2r+1)^2 median of a u8 image (or per-channel u8[H, W, C]) with
    replicate borders -- the ctmf capability (ctmf.c:378, commfunc.cc:11-25)
    as a scatter-free dense program: 8-step binary search over intensity;
    each step counts window pixels <= the center's probe value by walking
    the static window offsets (the per-center threshold rules out a single
    box-sum, but the offset walk is fully vectorized).
    """
    if img.ndim == 3:
        return jnp.stack([median_filter_u8(img[..., c], radius)
                          for c in range(img.shape[-1])], axis=-1)
    h, w = img.shape
    wnd = 2 * radius + 1
    pad = jnp.pad(img, radius, mode="edge").astype(jnp.int32)
    half = (wnd * wnd + 1) // 2

    def count_le(mid):
        def body(o, acc):
            dy, dx = o // wnd, o % wnd
            q = jax.lax.dynamic_slice(pad, (dy, dx), (h, w))
            return acc + (q <= mid)
        return jax.lax.fori_loop(0, wnd * wnd, body,
                                 jnp.zeros((h, w), jnp.int32))

    lo = jnp.zeros((h, w), jnp.int32)
    hi = jnp.full((h, w), 255, jnp.int32)

    def step(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) >> 1
        ge = count_le(mid) >= half
        return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)

    lo, hi = jax.lax.fori_loop(0, 8, step, (lo, hi))
    return lo.astype(jnp.uint8)
