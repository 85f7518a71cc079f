"""Quadrant-volume prescreen (ops.prescreen_volume).

For a fronto-parallel candidate (a = b = 0) the hypothesis disparity is
constant over the window, so the quadrant decomposition is EXACT:
sum_Q lerp(B_Q[c], dq) == sum_q w(c,q) * lerp(vol[q], dq) by linearity --
including the window border clip (zero quadrant weights) and the
saturation branch (sum_Q W_Q * maxc == sum_q w * maxc).  That equality
pins the build; slanted-candidate behavior is only a ranking heuristic
and is covered by the end-to-end quality test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from crossscalepatchmatch import CSPMConfig, CostMethod
from crossscalepatchmatch.data import make_pair
from crossscalepatchmatch.metrics import bad_pixel_rate
from crossscalepatchmatch.models.pipeline import run_pair_np
from crossscalepatchmatch.ops.prescreen_volume import (
    build_quadrant_volumes, quadrant_prescreen_cost)
from crossscalepatchmatch.ops.plane_cost import window_plane_cost


def _scene(h=32, w=44, d=10, seed=0):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    img = jax.random.randint(k1, (h, w, 3), 0, 255, jnp.uint8)
    vol = jax.random.uniform(k2, (h, w, d + 1), jnp.float32)
    return img, vol, jnp.max(vol)


@pytest.mark.parametrize("c_val", [3.5, 1.0, 8.999])
def test_fronto_parallel_exact(c_val):
    img, vol, mc = _scene()
    h, w = img.shape[:2]
    max_dis = 10
    abc = jnp.zeros((2, h, w, 3)).at[..., 2].set(
        jnp.array([c_val, 0.5])[:, None, None])   # k=1 out-of-range too
    bq, wq = build_quadrant_volumes(img, vol, half_wnd=3, gamma=10.0,
                                    stride=1)
    got = quadrant_prescreen_cost(bq, wq, mc, abc, half_wnd=3,
                                  max_dis=max_dis)
    want = window_plane_cost(img, vol, mc, abc, half_wnd=3,
                             max_dis=max_dis, gamma=10.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_quadrant_weights_partition_window():
    # sum of the four quadrant weight sums == total ASW window weight
    img, vol, mc = _scene(seed=3)
    bq, wq = build_quadrant_volumes(img, vol, half_wnd=4, gamma=10.0,
                                    stride=1)
    h, w = img.shape[:2]
    abc = jnp.zeros((1, h, w, 3)).at[..., 2].set(5.0)
    # total weight from the exact path: cost of a constant-1 volume
    ones = jnp.ones_like(vol)
    total_w = window_plane_cost(img, ones, jnp.float32(1.0), abc,
                                half_wnd=4, max_dis=10, gamma=10.0)[0]
    np.testing.assert_allclose(np.asarray(jnp.sum(wq, axis=0)),
                               np.asarray(total_w), rtol=2e-4, atol=2e-4)


def test_end_to_end_volume_prescreen_quality():
    """prescreen_mode="volume" must solve the scene about as well as the
    strided-window prescreen (it is a ranking heuristic; adoption still
    compares exact costs)."""
    pair = make_pair(h=48, w=64, max_dis=12, seed=11)
    base = dict(max_dis=12, dis_scale=16, wnd_size=11,
                cost_method=CostMethod.GRD, max_iter=2)
    bads = {}
    for mode in ("window", "volume"):
        cfg = CSPMConfig(**base, prescreen_mode=mode)
        out = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp = out["dis"][0].astype(np.float32) / cfg.dis_scale
        bads[mode] = bad_pixel_rate(disp, pair.disp_left, pair.valid_left,
                                    1.0)
    assert bads["volume"] < 0.15, bads
    assert bads["volume"] < bads["window"] + 0.05, bads
