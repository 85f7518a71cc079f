"""The fused GPU window-cost kernel (ops.pallas.window_cost) against the jnp
authority (ops.plane_cost), in the Pallas interpreter on the CPU.

The interpreter runs the kernel's own index arithmetic, masking, trunc and
saturation, so these tests pin its semantics; on the card the same checks
run compiled at real widths in chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crossscalepatchmatch.ops.pallas.window_cost import (
    cross_scale_cost_prepared, prepare, window_cost_prepared)
from crossscalepatchmatch.ops.plane_cost import (cross_scale_plane_cost,
                                                 window_plane_cost)


def _planes(ab, dc, h, w):
    xs = jnp.arange(w, dtype=jnp.float32)
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    c = dc - ab[..., 0] * xs - ab[..., 1] * ys
    return jnp.concatenate([ab, c[..., None]], axis=-1)


def _plane_batch(key, k, h, w, d, spread=1.0):
    ka, kd = jax.random.split(key)
    ab = jax.random.uniform(ka, (2, k, h, w, 2), jnp.float32,
                            -spread, spread)
    dc = jax.random.uniform(kd, (2, k, h, w), jnp.float32, 0, d)
    return _planes(ab, dc, h, w)


def _scene(h, w, d, seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    imgs = jax.random.randint(k1, (2, h, w, 3), 0, 255, jnp.uint8)
    vols = jax.random.uniform(k2, (2, h, w, d + 1), jnp.float32)
    return imgs, vols, jnp.max(vols, axis=(1, 2, 3))


def _jnp_cost(imgs, vols, mc, abc, wnd, d, **kw):
    return jax.vmap(lambda i, v, m, a: window_plane_cost(
        i, v, m, a, half_wnd=wnd // 2, max_dis=d, gamma=10.0, **kw))(
            imgs, vols, mc, abc)


def _kernel_cost(imgs, vols, mc, abc, wnd, d, **kw):
    return window_cost_prepared(prepare(imgs, vols), mc, abc,
                                half_wnd=wnd // 2, max_dis=d, gamma=10.0,
                                interpret=True, **kw)


@pytest.mark.parametrize("k", [1, 3])
def test_kernel_matches_jnp_interpret(k):
    h, w, d, wnd = 24, 40, 8, 5
    imgs, vols, mc = _scene(h, w, d, 0)
    abc = _plane_batch(jax.random.PRNGKey(1), k, h, w, d)
    got = _kernel_cost(imgs, vols, mc, abc, wnd, d)
    want = _jnp_cost(imgs, vols, mc, abc, wnd, d)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_kernel_deep_volume_matches_jnp_interpret():
    """Deep volume (D=40), a smooth narrow-band candidate and a wild
    whole-volume candidate in the same batch."""
    h, w, d, wnd = 16, 40, 40, 5
    imgs, vols, mc = _scene(h, w, d, 7)
    k2, k3 = jax.random.split(jax.random.PRNGKey(8))
    # candidate 0: near-fronto planes in a narrow disparity band
    ab0 = jax.random.uniform(k3, (2, 1, h, w, 2), jnp.float32, -0.05, 0.05)
    dc0 = jax.random.uniform(k3, (2, 1, h, w), jnp.float32, 20.0, 24.0)
    # candidate 1: arbitrary planes spanning the whole volume
    ab1 = jax.random.uniform(k2, (2, 1, h, w, 2), jnp.float32, -1, 1)
    dc1 = jax.random.uniform(k2, (2, 1, h, w), jnp.float32, 0, d)
    for ab, dc in [(ab0, dc0),
                   (jnp.concatenate([ab0, ab1], axis=1),
                    jnp.concatenate([dc0, dc1], axis=1))]:
        abc = _planes(ab, dc, h, w)
        got = _kernel_cost(imgs, vols, mc, abc, wnd, d)
        want = _jnp_cost(imgs, vols, mc, abc, wnd, d)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_kernel_slanted_plus_wild_matches_jnp_interpret():
    """A converged SLANTED field (dq spans ~a*width disparities across the
    tile) with a wild whole-volume candidate mixed in -- the two field
    regimes the optimizer actually feeds the kernel."""
    h, w, d, wnd = 24, 64, 32, 5
    imgs, vols, mc = _scene(h, w, d, 11)
    k3, k4 = jax.random.split(jax.random.PRNGKey(12))
    xs = jnp.arange(w, dtype=jnp.float32)
    # slanted field: common slope 0.25 with small per-pixel jitter
    a0 = 0.25 + jax.random.uniform(k3, (2, 1, h, w), jnp.float32,
                                   -0.02, 0.02)
    b0 = jax.random.uniform(k3, (2, 1, h, w), jnp.float32, -0.03, 0.03)
    dc0 = (4.0 + 0.25 * xs
           + jax.random.uniform(k3, (2, 1, h, w), jnp.float32, -0.5, 0.5))
    # wild candidate: spans the whole volume (fallback in the same launch)
    ab1 = jax.random.uniform(k4, (2, 1, h, w, 2), jnp.float32, -1, 1)
    dc1 = jax.random.uniform(k4, (2, 1, h, w), jnp.float32, 0, d)
    ab = jnp.concatenate([jnp.stack([a0, b0], axis=-1), ab1], axis=1)
    abc = _planes(ab, jnp.concatenate([dc0, dc1], axis=1), h, w)

    prep = prepare(imgs, vols)
    got = window_cost_prepared(prep, mc, abc, half_wnd=wnd // 2, max_dis=d,
                               gamma=10.0, interpret=True)
    want = _jnp_cost(imgs, vols, mc, abc, wnd, d)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_kernel_wnd_stride_matches_jnp_interpret():
    """Strided (prescreen) window evaluation: kernel vs jnp, stride 2."""
    h, w, d, wnd = 24, 40, 8, 7
    imgs, vols, mc = _scene(h, w, d, 9)
    abc = _plane_batch(jax.random.PRNGKey(10), 2, h, w, d)
    got = jax.jit(lambda i, v, m, a: _kernel_cost(
        i, v, m, a, wnd, d, wnd_stride=2))(imgs, vols, mc, abc)
    want = _jnp_cost(imgs, vols, mc, abc, wnd, d, wnd_stride=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_cross_scale_kernel_matches_jnp_interpret():
    """Direct indexing of the coarse levels at (y >> s, x >> s) equals the
    jnp authority's nearest-upsampled arrays."""
    h, w, max_dis, wnd, k, scales = 24, 40, 8, 5, 2, 3
    keys = jax.random.split(jax.random.PRNGKey(1), 2 * scales + 1)
    hs, ws, md = h, w, max_dis
    imgs, vols, mcs = [], [], []
    for s in range(scales):
        imgs.append(jax.random.randint(keys[2 * s], (2, hs, ws, 3), 0, 255,
                                       jnp.uint8))
        v = jax.random.uniform(keys[2 * s + 1], (2, hs, ws, md + 1),
                               jnp.float32)
        vols.append(v)
        mcs.append(jnp.max(v, axis=(1, 2, 3)))
        hs, ws, md = (hs + 1) // 2, (ws + 1) // 2, md // 2
    abc = _plane_batch(keys[-1], k, h, w, max_dis)
    wgts = (0.5, 0.3, 0.2)

    preps = [prepare(i, v) for i, v in zip(imgs, vols)]
    got = cross_scale_cost_prepared(preps, mcs, wgts, abc,
                                    half_wnd=wnd // 2, max_dis=max_dis,
                                    gamma=10.0, interpret=True)
    want = jax.vmap(lambda i0, i1, i2, v0, v1, v2, m, a: cross_scale_plane_cost(
        [i0, i1, i2], [v0, v1, v2], m, wgts, a,
        half_wnd=wnd // 2, max_dis=max_dis, gamma=10.0))(
            imgs[0], imgs[1], imgs[2], vols[0], vols[1], vols[2],
            jnp.stack(mcs, 1), abc)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_kernel_bf16_volume_close_to_f32_interpret():
    """vol_dtype="bf16": the kernel reads a bf16-stored volume and
    accumulates in f32, so it must match the jnp authority fed the same
    bf16-rounded volume to f32 accuracy."""
    h, w, d, wnd = 24, 40, 8, 5
    imgs, vols, _ = _scene(h, w, d, 21)
    vols = vols * 2.8
    mc = jnp.max(vols, axis=(1, 2, 3))
    abc = _plane_batch(jax.random.PRNGKey(22), 3, h, w, d)

    prep = prepare(imgs, vols, jnp.bfloat16)
    assert prep.vol.dtype == jnp.bfloat16
    got = window_cost_prepared(prep, mc, abc, half_wnd=wnd // 2, max_dis=d,
                               gamma=10.0, interpret=True)
    vols_rounded = vols.astype(jnp.bfloat16).astype(jnp.float32)
    want = _jnp_cost(imgs, vols_rounded, mc, abc, wnd, d)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_kernel_ragged_shape_padding_interpret():
    """H, W that are multiples of no tile: edge programs clamp their
    parameter reads and write into the padded output, which is cropped."""
    h, w, d, wnd = 37, 53, 8, 5
    imgs, vols, mc = _scene(h, w, d, 3)
    abc = _plane_batch(jax.random.PRNGKey(4), 2, h, w, d)
    got = _kernel_cost(imgs, vols, mc, abc, wnd, d)
    assert got.shape == (2, 2, h, w)
    want = _jnp_cost(imgs, vols, mc, abc, wnd, d)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_kernel_ybounds_band_matches_full_image_interpret():
    """Sharded-band semantics: a row band with real neighbor-halo rows on
    one side and past-the-border rows on the other, evaluated with the
    [ylo, yhi) bounds and the halo origin, reproduces the full-image cost
    rows."""
    h, w, d, wnd = 32, 40, 8, 9
    hb = wnd // 2
    hs = h // 2                       # band = bottom half (ty=1 of 2)
    imgs, vols, mc = _scene(h, w, d, 3)
    abc = _plane_batch(jax.random.PRNGKey(5), 2, h, w, d)
    want = _jnp_cost(imgs, vols, mc, abc, wnd, d)[:, :, hs:]

    # band arrays: real halo rows above, zero (past-border) rows below
    def band(x):
        top = x[:, hs - hb:]
        pad = jnp.zeros((x.shape[0], hb) + x.shape[2:], x.dtype)
        return jnp.concatenate([top, pad], axis=1)

    # re-anchor planes into local band rows: c_local = c + b * hs
    abc_b = abc[:, :, hs:].at[..., 2].add(abc[:, :, hs:, :, 1] * hs)
    bounds = jnp.array([hb - hs, hb + hs, 0, w], jnp.int32)
    got = window_cost_prepared(prepare(band(imgs), band(vols)), mc, abc_b,
                               half_wnd=hb, max_dis=d, gamma=10.0,
                               origin=(hb, 0), bounds=bounds, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_cs,lab", [(False, False), (True, False),
                                        (False, True)])
def test_kernel_cost_fns_match_jnp_interpret(use_cs, lab):
    """The optimizer's kernel binding (models.patchmatch._kernel_cost_fns)
    agrees with its jnp binding on real volumes: exact evaluator, and the
    strided one for single scale; with Lab weights the kernel's image
    input is the Lab conversion (USE_LAB_WGT, grd_pc.h:25)."""
    from crossscalepatchmatch import CSPMConfig, CostMethod
    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.models import patchmatch as pm
    from crossscalepatchmatch.ops.cost_volume import build_volume_data

    h, w, d = 32, 40, 8
    cfg = CSPMConfig(max_dis=d, dis_scale=16, wnd_size=7, use_cs=use_cs,
                     scale_num=2, reg_lambda=0.3,
                     cost_method=CostMethod.CEN if use_cs else CostMethod.GRD,
                     prescreen_mode="window", use_lab_weights=lab)
    pair = make_pair(h=h, w=w, max_dis=d, seed=4)
    vd = build_volume_data(jnp.asarray(pair.left), jnp.asarray(pair.right),
                           cfg)
    abc = _plane_batch(jax.random.PRNGKey(6), 2, h, w, d, spread=0.3)
    k_cost, k_sparse = pm._kernel_cost_fns(cfg, vd, interpret=True)
    j_cost, j_sparse = pm._jnp_cost_fns(cfg, vd)
    pairs = [(k_cost, j_cost)]
    if not use_cs:
        pairs.append((k_sparse, j_sparse))
    else:
        assert k_sparse is None and j_sparse is None
    for kf, jf in pairs:
        np.testing.assert_allclose(np.asarray(kf(abc)), np.asarray(jf(abc)),
                                   rtol=1e-5, atol=1e-4)
