"""Slanted-plane parameter math.

The reference stores per-pixel planes as (normal, point) pairs and derives the
disparity-plane parameters (a, b, c) with d(x, y) = a*x + b*y + c on every
update (CSPM/plane.h:25-34).  The cost function only ever consumes (a, b, c),
and spatial/view propagation copy planes wholesale, so this engine
stores *only* the (a, b, c) triple as a dense f32[..., 3] field and
reconstructs a unit normal on demand for the refinement perturbation.

The (a, b, c) parameterization is invariant to the sign of the normal
(plane.h:27-30 keeps the sign of nz in the denominator, which cancels), so
reconstructing the nz > 0 representative loses nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def params_from_normal_point(normal: jax.Array, point: jax.Array,
                             eps: float = 1e-8) -> jax.Array:
    """(a, b, c) from a plane normal and a point (x, y, disparity) on it.

    Matches Plane::update_param (CSPM/plane.h:25-34): the denominator is
    max(|nz|, eps) with the sign of nz preserved.
    """
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    denom = jnp.maximum(jnp.abs(nz), eps) * jnp.where(nz < 0.0, -1.0, 1.0)
    a = -nx / denom
    b = -ny / denom
    c = jnp.sum(normal * point, axis=-1) / denom
    return jnp.stack([a, b, c], axis=-1)


def normal_from_params(abc: jax.Array) -> jax.Array:
    """Unit normal (with nz > 0) of the plane with parameters (a, b, c).

    Inverse of params_from_normal_point up to normal sign: a = -nx/nz,
    b = -ny/nz implies n ~ (-a, -b, 1).
    """
    a, b = abc[..., 0], abc[..., 1]
    inv_len = jax.lax.rsqrt(a * a + b * b + 1.0)
    return jnp.stack([-a * inv_len, -b * inv_len, inv_len], axis=-1)


def disparity_at(abc: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Evaluate d(x, y) = a*x + b*y + c."""
    return abc[..., 0] * x + abc[..., 1] * y + abc[..., 2]


def reanchor(abc: jax.Array, x: jax.Array, y: jax.Array,
             disp: jax.Array) -> jax.Array:
    """Plane with the same orientation (a, b) passing through (x, y, disp).

    Used by view propagation (cs_patchmatch.cc:265-267) and the cross-scale
    plane re-derivation (pre_cs_pc.cc:144): the normal is kept, the anchor
    point changes, so only c is recomputed: c = disp - a*x - b*y.
    """
    a, b = abc[..., 0], abc[..., 1]
    c = disp - a * x - b * y
    return jnp.stack([a, b, c], axis=-1)


def random_planes(key: jax.Array, shape: tuple, max_dis: float,
                  eps: float = 1e-8) -> jax.Array:
    """Random plane init: disparity ~ U(eps, max_dis) at the pixel, random
    isotropic unit normal from N(0,1)^3 (cs_patchmatch.cc:115-148).

    Unlike the reference, which re-seeds a per-row RNG with time(NULL) under
    OpenMP (cs_patchmatch.cc:130 -- every row gets the *same* stream within a
    second), this uses a counter-based threefry split: every pixel gets an
    independent stream.

    Args:
      key: PRNG key.
      shape: leading shape, e.g. (views, H, W).
      max_dis: maximum disparity (exclusive upper bound of the uniform draw).

    Returns:
      f32[*shape, 3] plane parameters (a, b, c).
    """
    kd, kn = jax.random.split(key)
    disp = jax.random.uniform(kd, shape, jnp.float32, eps, max_dis)
    normal = jax.random.normal(kn, (*shape, 3), jnp.float32)
    norm = jnp.maximum(jnp.linalg.norm(normal, axis=-1, keepdims=True), eps)
    normal = normal / norm
    h, w = shape[-2], shape[-1]
    y = jax.lax.broadcasted_iota(jnp.float32, shape, len(shape) - 2)
    x = jax.lax.broadcasted_iota(jnp.float32, shape, len(shape) - 1)
    point = jnp.stack([x, y, disp], axis=-1)
    return params_from_normal_point(normal, point, eps)


def perturb_planes(key: jax.Array, abc: jax.Array, z_mag: float, n_mag: float,
                   eps: float = 1e-8) -> jax.Array:
    """Refinement proposal: disparity jittered by U(-z_mag, z_mag) at the
    pixel, normal jittered componentwise by U(-n_mag, n_mag) and renormalized
    (cs_patchmatch.cc:311-338).

    Args:
      abc: f32[..., H, W, 3] current plane parameters.
      z_mag / n_mag: current perturbation magnitudes.

    Returns:
      f32 like `abc`: proposed plane parameters.
    """
    shape = abc.shape[:-1]
    kd, kn = jax.random.split(key)
    y = jax.lax.broadcasted_iota(jnp.float32, shape, len(shape) - 2)
    x = jax.lax.broadcasted_iota(jnp.float32, shape, len(shape) - 1)
    z = disparity_at(abc, x, y) + jax.random.uniform(
        kd, shape, jnp.float32, -z_mag, z_mag)
    delta = jax.random.uniform(kn, (*shape, 3), jnp.float32, -n_mag, n_mag)
    normal = normal_from_params(abc) + delta
    norm = jnp.maximum(jnp.linalg.norm(normal, axis=-1, keepdims=True), eps)
    normal = normal / norm
    point = jnp.stack([x, y, z], axis=-1)
    return params_from_normal_point(normal, point, eps)
