"""Census transform and census-Hamming cost volume.

Reference semantics (cc/cen_cc.cc):
  * 9x9 window, center excluded -> 80 comparison bits (cen_cc.h:5-6);
  * window coordinates wrap around the image borders via modulo
    (cen_cc.cc:30-43) -- reproduced here with jnp.roll;
  * bit b is set iff center > neighbor, bits ordered row-major over the
    window skipping (0, 0);
  * cost[d](x) = popcount(l(x) XOR r(x-d)), with the maximum cost (80) for
    columns where x-d is out of range (cen_cc.cc:56-64); the right-referenced
    volume mirrors this with x+d (cen_cc.cc:120-133).

Bits are packed into ceil(bits/32) uint32 words so the Hamming distance is a
handful of XOR + population_count ops per pixel instead of an 80-wide bool
tensor.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def census_transform(gray_u8: jax.Array, wnd: int = 9) -> jax.Array:
    """Bit-packed census codes.

    Args:
      gray_u8: u8[H, W] grayscale image.
      wnd: odd census window size.

    Returns:
      u32[H, W, ceil((wnd*wnd-1)/32)] packed comparison bits.
    """
    half = wnd // 2
    bits = wnd * wnd - 1
    words = (bits + 31) // 32
    g = gray_u8.astype(jnp.int32)
    packed = [jnp.zeros(gray_u8.shape, jnp.uint32) for _ in range(words)]
    bit_idx = 0
    for wy in range(-half, half + 1):
        for wx in range(-half, half + 1):
            if wy == 0 and wx == 0:
                continue
            neighbor = jnp.roll(g, (-wy, -wx), axis=(0, 1))
            bit = (g > neighbor).astype(jnp.uint32)
            w, b = bit_idx // 32, bit_idx % 32
            packed[w] = packed[w] | (bit << b)
            bit_idx += 1
    return jnp.stack(packed, axis=-1)


def _hamming(a: jax.Array, b: jax.Array) -> jax.Array:
    """Popcount of XOR over the packed-word axis -> i32[H, W]."""
    return jnp.sum(jax.lax.population_count(a ^ b), axis=-1).astype(jnp.int32)


def census_cost_volume(l_gray_u8: jax.Array, r_gray_u8: jax.Array,
                       max_dis: int, wnd: int = 9,
                       right: bool = False) -> jax.Array:
    """Census-Hamming cost volume with d in [0, max_dis] inclusive.

    Args:
      l_gray_u8 / r_gray_u8: u8[H, W] grayscale views.
      max_dis: maximum disparity; the volume has max_dis+1 slices.
      right: build the right-referenced volume (match at x+d in the left view)
        instead of the left-referenced one (match at x-d in the right view).

    Returns:
      f32[H, W, max_dis+1].
    """
    bits = wnd * wnd - 1
    l_code = census_transform(l_gray_u8, wnd)
    r_code = census_transform(r_gray_u8, wnd)
    h, w = l_gray_u8.shape
    x = jnp.arange(w)[None, :]
    slices = []
    for d in range(max_dis + 1):
        if right:
            shifted = jnp.roll(l_code, -d, axis=1)
            cost = _hamming(r_code, shifted)
            cost = jnp.where(x + d < w, cost, bits)
        else:
            shifted = jnp.roll(r_code, d, axis=1)
            cost = _hamming(l_code, shifted)
            cost = jnp.where(x - d >= 0, cost, bits)
        slices.append(cost)
    return jnp.stack(slices, axis=-1).astype(jnp.float32)
