"""Golden tests for the on-the-fly (GrdPC/CSPC) plane-cost path."""

import numpy as np
import jax.numpy as jnp
import pytest

from crossscalepatchmatch import CSPMConfig, CostMethod
from crossscalepatchmatch.data import make_pair
from crossscalepatchmatch.metrics import bad_pixel_rate
from crossscalepatchmatch.models.pipeline import run_pair_np
from crossscalepatchmatch.ops.onthefly_cost import (grd_fly_cost,
                                                        gray_gradient)


def np_gray_grad(bgr):
    g = (0.299 * bgr[..., 2] + 0.587 * bgr[..., 1]
         + 0.114 * bgr[..., 0]).astype(np.float64)
    out = np.zeros_like(g)
    out[:, 1:-1] = g[:, 2:] - g[:, :-2]
    return out


def np_grd_fly(ref, oth, abc, sign, half, max_dis, gamma=10.0, alpha=0.1,
               tau_clr=10.0, tau_grd=2.0):
    """Literal nested-loop GrdPC::GetPlaneCost (grd_pc.cc:71-178)."""
    h, w, _ = ref.shape
    rg = np_gray_grad(ref)
    og = np_gray_grad(oth)
    refd = ref.astype(np.float64)
    othd = oth.astype(np.float64)
    k = abc.shape[0]
    out = np.zeros((k, h, w))
    sat = alpha * tau_clr + (1 - alpha) * tau_grd
    for kk in range(k):
        for y in range(h):
            for x in range(w):
                a, b, c = abc[kk, y, x]
                acc = 0.0
                for dy in range(-half, half + 1):
                    qy = y + dy
                    if not (0 <= qy < h):
                        continue
                    for dx in range(-half, half + 1):
                        qx = x + dx
                        if not (0 <= qx < w):
                            continue
                        l1 = int(np.abs(ref[y, x].astype(np.int64)
                                        - ref[qy, qx]).sum())
                        wgt = np.exp(-l1 / gamma)
                        dq = a * qx + b * qy + c
                        f = int(dq)   # trunc
                        if f <= 0 or f >= max_dis:
                            acc += wgt * sat
                            continue
                        ox = qx + sign * dq
                        fx = int(ox)
                        fw = fx + 1 - ox
                        fxw = fx + w if fx < 0 else (fx - w if fx >= w else fx)
                        cx = fx + 1
                        cxw = cx + w if cx < 0 else (cx - w if cx >= w else cx)
                        lerp = fw * othd[qy, fxw] + (1 - fw) * othd[qy, cxw]
                        clr = np.abs(refd[qy, qx] - lerp).mean()
                        glerp = fw * og[qy, fxw] + (1 - fw) * og[qy, cxw]
                        grd = abs(rg[qy, qx] - glerp)
                        acc += wgt * (alpha * min(clr, tau_clr)
                                      + (1 - alpha) * min(grd, tau_grd))
                out[kk, y, x] = acc
    return out


def test_grd_fly_matches_oracle():
    rng = np.random.default_rng(4)
    h, w, max_dis, half = 14, 18, 6, 2
    ref = rng.integers(0, 255, (h, w, 3), np.uint8)
    oth = rng.integers(0, 255, (h, w, 3), np.uint8)
    ab = rng.uniform(-0.5, 0.5, (2, h, w, 2))
    dc = rng.uniform(0, max_dis, (2, h, w))
    xs = np.arange(w)[None, :]
    ys = np.arange(h)[:, None]
    c = dc - ab[..., 0] * xs - ab[..., 1] * ys
    abc = np.concatenate([ab, c[..., None]], -1).astype(np.float32)

    got = np.asarray(grd_fly_cost(
        jnp.asarray(ref), jnp.asarray(oth), gray_gradient(jnp.asarray(ref)),
        gray_gradient(jnp.asarray(oth)), jnp.asarray(abc), sign=-1,
        half_wnd=half, max_dis=max_dis, gamma=10.0))
    want = np_grd_fly(ref, oth, abc.astype(np.float64), -1, half, max_dis)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("use_cs", [
    False, pytest.param(True, marks=pytest.mark.slow)])
def test_fly_pipeline_solves_scene(use_cs):
    pair = make_pair(h=64, w=96, max_dis=12, seed=7)
    cfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=15,
                     cost_method=CostMethod.GRD, use_cs=use_cs,
                     scale_num=3, reg_lambda=0.3 if use_cs else 0.0,
                     precompute_volume=False)
    out = run_pair_np(pair.left, pair.right, cfg, seed=0)
    disp = out["dis"][0].astype(np.float32) / cfg.dis_scale
    bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left)
    assert bad < 0.15, bad


def test_fly_requires_grd():
    with pytest.raises(ValueError):
        CSPMConfig(cost_method=CostMethod.CEN, precompute_volume=False)
