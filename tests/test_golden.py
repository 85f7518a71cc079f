"""Hand-derived golden fixtures, computed on paper from the reference's
arithmetic -- NOT via either implementation (engine or native oracle).

Both sides of the usual parity checks (the JAX engine and csrc/cspm_oracle)
were written from the same reading of the reference sources; a shared
misreading would pass every cross-check.  These fixtures pin a handful of
values derived BY HAND, literally from the reference's expressions, so a
semantic drift in either implementation fails loudly:

  * the window-cost saturation branches of pre_ss_pc.cc:99-111
    (trunc(dq) == 0, == max_dis, negative C-trunc, in-range boundary taps);
  * the ASW weight exp(-L1/gamma) of pre_ss_pc.cc:92-98;
  * census wrap-around borders and out-of-range max cost (cen_cc.cc:30-64);
  * GrdCC TAD mixing and the border pseudo-cost (grd_cc.cpp:4-35);
  * GrdPC's CONSTANT saturation alpha*tau_clr+(1-alpha)*tau_grd
    (grd_pc.cc:120-123) vs the Pre* max-volume saturation -- they differ,
    both are pinned;
  * GrdPC's sub-pixel warp with HandleBorder wrap and the trunc-toward-zero
    floor weight that exceeds 1 for negative warp columns
    (grd_pc.cc:149-171, commfunc.h:107-145);
  * the tridiagonal inter-scale weights (pre_cs_pc.cc:85-109);
  * Plane::update_param including the nz ~ 0 guard (plane.h:25-34).

Every expected number carries its derivation in a comment.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from crossscalepatchmatch.ops.census import census_cost_volume
from crossscalepatchmatch.ops.grad_cost import grd_cost_volume
from crossscalepatchmatch.ops.onthefly_cost import (grd_fly_cost,
                                                        gray_gradient)
from crossscalepatchmatch.ops.plane import params_from_normal_point
from crossscalepatchmatch.ops.plane_cost import window_plane_cost
from crossscalepatchmatch.ops.scale_weights import scale_weights


def _const_rgb(h, w, val):
    return np.full((h, w, 3), val, np.uint8)


def _window_cost(img, vol, max_cost, abc, max_dis=4, gamma=10.0):
    out = window_plane_cost(jnp.asarray(img), jnp.asarray(vol),
                            jnp.float32(max_cost),
                            jnp.asarray(abc, jnp.float32)[None],
                            half_wnd=1, max_dis=max_dis, gamma=gamma)
    return np.asarray(out)[0]


class TestWindowCostSaturation:
    """pre_ss_pc.cc:74-118 on a 5x5 constant image, vol[y,x,d] = 10*d.

    Constant color -> every ASW weight is exp(0) = 1, so the window cost is
    simply (number of in-image window pixels) * per-pixel data value, and
    every branch value is computable in one line.  max_dis = 4, D = 5
    slices, max_cost = max(vol) = 40.
    """

    @classmethod
    def setup_class(cls):
        cls.img = _const_rgb(5, 5, 100)
        d = np.arange(5, dtype=np.float32) * 10.0
        cls.vol = np.broadcast_to(d, (5, 5, 5)).copy()
        cls.maxc = 40.0

    def _cost(self, a, b, c):
        abc = np.zeros((5, 5, 3), np.float32)
        abc[..., 0] = a
        abc[..., 1] = b
        abc[..., 2] = c
        return _window_cost(self.img, self.vol, self.maxc, abc)

    def test_interior_lerp(self):
        # dq = 2.5 everywhere: trunc = 2 in [1, 3] -> in range.
        # floor_wgt = (2+1) - 2.5 = 0.5; val = 0.5*vol[2] + 0.5*vol[3]
        #           = 0.5*20 + 0.5*30 = 25.
        # center (2,2): 9 window pixels, all weights 1 -> 9 * 25 = 225.
        c = self._cost(0.0, 0.0, 2.5)
        assert c[2, 2] == pytest.approx(225.0, rel=1e-6)
        # corner (0,0): only the 2x2 in-image window pixels -> 4 * 25 = 100
        # (window pixels outside the image are skipped, pre_ss_pc.cc:84-91).
        assert c[0, 0] == pytest.approx(100.0, rel=1e-6)

    def test_trunc_zero_saturates(self):
        # dq = 0.5: trunc = 0, fails f >= 1 (the reference tests
        # floorDis <= 0, pre_ss_pc.cc:101) -> val = max_cost = 40.
        assert self._cost(0, 0, 0.5)[2, 2] == pytest.approx(9 * 40.0)

    def test_trunc_equal_max_dis_saturates(self):
        # dq = 4.0 = max_dis exactly: trunc = 4, fails f <= max_dis-1 = 3
        # (the reference tests floorDis >= maxDis) -> 9 * 40.
        assert self._cost(0, 0, 4.0)[2, 2] == pytest.approx(9 * 40.0)

    def test_last_valid_floor_taps_top_slice(self):
        # dq = 3.5: trunc = 3 = max_dis - 1 -> IN range; taps slices 3, 4:
        # val = 0.5*30 + 0.5*40 = 35 -> 9 * 35 = 315.
        assert self._cost(0, 0, 3.5)[2, 2] == pytest.approx(315.0, rel=1e-6)

    def test_negative_dq_c_trunc(self):
        # C truncation is toward zero: trunc(-0.5) = 0 (not floor's -1) and
        # trunc(-1.5) = -1; both fail f >= 1 -> saturation.
        assert self._cost(0, 0, -0.5)[2, 2] == pytest.approx(9 * 40.0)
        assert self._cost(0, 0, -1.5)[2, 2] == pytest.approx(9 * 40.0)

    def test_integer_dq_hits_slice_exactly(self):
        # dq = 1.0: trunc = 1 (in range); floor_wgt = 2 - 1 = 1 ->
        # val = 1*vol[1] + 0*vol[2] = 10 -> 9 * 10 = 90.
        assert self._cost(0, 0, 1.0)[2, 2] == pytest.approx(90.0, rel=1e-6)

    def test_slanted_plane(self):
        # a = 0.5, c = 2.0: hypothesis at window pixel q is evaluated from
        # the plane itself, dq(q) = 0.5*q_x + 2.  At center (2,2):
        # columns q_x = 1,2,3 -> dq = 2.5, 3.0, 3.5 -> val = 25, 30, 35.
        # 3 rows each -> 3 * (25+30+35) = 270.
        assert self._cost(0.5, 0.0, 2.0)[2, 2] == pytest.approx(
            270.0, rel=1e-6)


def test_asw_weight_exp_l1():
    """pre_ss_pc.cc:92-98: w = exp(-(|dB|+|dG|+|dR|)/gamma).

    3x3 image, center (10,20,30), all others (12,25,33):
    L1 = 2+5+3 = 10 -> w = exp(-10/10) = e^-1.  Volume is constant 7 with
    plane dq = 2 (in range, lerp = 7), so
    center cost = 1*7 + 8*e^-1*7 = 7 + 56*e^-1 = 27.601249...
    """
    img = np.full((3, 3, 3), 0, np.uint8)
    img[...] = (12, 25, 33)
    img[1, 1] = (10, 20, 30)
    vol = np.full((3, 3, 5), 7.0, np.float32)
    abc = np.zeros((3, 3, 3), np.float32)
    abc[..., 2] = 2.0
    c = _window_cost(img, vol, 7.0, abc)
    want = 7.0 + 56.0 * np.exp(-1.0)
    assert c[1, 1] == pytest.approx(want, rel=1e-6)


class TestCensusGolden:
    """cen_cc.cc:4-70 on a 1x3 pair, census_wnd=3 (8 bits), max_dis=1.

    All window rows wrap to row 0 (the reference wraps both axes with
    (p + wp + n) % n, cen_cc.cc:30-43).  Codes derived by hand, bit b set
    iff center > neighbor, bits ordered row-major skipping (0,0):

    L = [5, 9, 2]:
      x=0 (5): neighbors per offset = [2,5,9, 2,9, 2,5,9]
               -> bits 10010100 (b0,b3,b5) -> popcount pattern 41
      x=1 (9): neighbors [5,9,2, 5,2, 5,9,2] -> bits set b0,b2,b3,b4,b5,b7
               -> 189
      x=2 (2): 2 exceeds nothing -> 0
    R = [7, 3, 8]:
      x=0 (7): neighbors [8,7,3, 8,3, 8,7,3] -> b2,b4,b7 -> 148
      x=1 (3): -> 0
      x=2 (8): neighbors [3,8,7, 3,7, 3,8,7] -> b0,b2,b3,b4,b5,b7 -> 189

    Left volume (cost = popcount(l ^ r(x-d)), out-of-range -> 8):
      d=0: ham(41,148)=popcount(0b10111101)=6; ham(189,0)=6; ham(0,189)=6
      d=1: x0 out-of-range -> 8; ham(189,148)=popcount(0b00101001)=3;
           ham(0,0)=0
    """

    L = np.array([[5, 9, 2]], np.uint8)
    R = np.array([[7, 3, 8]], np.uint8)

    def test_left_volume(self):
        vol = np.asarray(census_cost_volume(jnp.asarray(self.L),
                                            jnp.asarray(self.R),
                                            max_dis=1, wnd=3))
        np.testing.assert_array_equal(vol[0, :, 0], [6, 6, 6])
        np.testing.assert_array_equal(vol[0, :, 1], [8, 3, 0])

    def test_right_volume(self):
        # mirrored: cost = ham(r(x), l(x+d)), x+d >= W -> 8
        # d=0: same Hamming distances (XOR is symmetric) -> [6, 6, 6]
        # d=1: ham(148,189)=3; ham(0,0)=0; x=2 out-of-range -> 8
        vol = np.asarray(census_cost_volume(jnp.asarray(self.L),
                                            jnp.asarray(self.R),
                                            max_dis=1, wnd=3, right=True))
        np.testing.assert_array_equal(vol[0, :, 0], [6, 6, 6])
        np.testing.assert_array_equal(vol[0, :, 1], [3, 0, 8])


class TestGrdCCGolden:
    """grd_cc.cpp:4-35,60-109 on a 1x4 pair with equal RGB channels.

    Channels equal -> gray == channel value, clr = mean_c|dC| = |dv|.
    Sobel ksize=1 = [-1,0,1] with REFLECT_101 borders (gradient 0 at the
    first/last column).

    L = [10,10,40,40] -> grad_L = [0, 30, 30, 0]
    R = [10,30,40,20] -> grad_R = [0, 30, -10, 0]
    mix(clr, grd) = 0.1*min(clr,10) + 0.9*min(grd,2)

    Left volume:
      d=0: x0: mix(0,0)   = 0
           x1: mix(20,0)  = 0.1*10 = 1.0
           x2: mix(0,40)  = 0.9*2  = 1.8
           x3: mix(20,0)  = 0.1*10 = 1.0
      d=1: x0 out-of-range -> border pseudo-cost vs BORDER_THRES=3:
           mix(|10-3|, |0-3|) = 0.1*7 + 0.9*2 = 2.5
           x1: mix(0, 30)  = 1.8
           x2: mix(10, 0)  = 1.0
           x3: mix(0, 10)  = 1.8
    """

    @classmethod
    def setup_class(cls):
        lv = np.array([10, 10, 40, 40], np.float32)
        rv = np.array([10, 30, 40, 20], np.float32)
        cls.L = np.repeat(lv, 3).reshape(1, 4, 3)
        cls.R = np.repeat(rv, 3).reshape(1, 4, 3)

    def test_left_volume(self):
        vol = np.asarray(grd_cost_volume(jnp.asarray(self.L),
                                         jnp.asarray(self.R), max_dis=1))
        np.testing.assert_allclose(vol[0, :, 0], [0.0, 1.0, 1.8, 1.0],
                                   atol=1e-5)
        np.testing.assert_allclose(vol[0, :, 1], [2.5, 1.8, 1.0, 1.8],
                                   atol=1e-5)


class TestGrdPCGolden:
    """grd_pc.cc:71-178: the on-the-fly path's saturation constant and
    sub-pixel warp, including the HandleBorder wrap and the trunc-derived
    floor weight that exceeds 1 for negative warp columns."""

    def test_saturation_is_constant_not_volume_max(self):
        # Out-of-range disparity saturates at wgt*(alpha*tau_clr +
        # (1-alpha)*tau_grd) = 1*(0.1*10 + 0.9*2) = 2.8 per window pixel
        # (grd_pc.cc:120-123) -- NOT the Pre* max-volume value.
        # Constant-color 3x3 views, plane dq = 0.5 (trunc=0 -> saturated):
        # center cost = 9 * 2.8 = 25.2.
        ref = jnp.asarray(_const_rgb(3, 3, 20))
        oth = jnp.asarray(_const_rgb(3, 3, 90))
        g_ref, g_oth = gray_gradient(ref), gray_gradient(oth)
        abc = np.zeros((1, 3, 3, 3), np.float32)
        abc[..., 2] = 0.5
        c = np.asarray(grd_fly_cost(ref, oth, g_ref, g_oth,
                                    jnp.asarray(abc), sign=-1, half_wnd=1,
                                    max_dis=4, gamma=10.0))
        assert c[0, 1, 1] == pytest.approx(9 * 2.8, rel=1e-6)
        # trunc(dq) == max_dis saturates identically
        abc[..., 2] = 4.0
        c = np.asarray(grd_fly_cost(ref, oth, g_ref, g_oth,
                                    jnp.asarray(abc), sign=-1, half_wnd=1,
                                    max_dis=4, gamma=10.0))
        assert c[0, 1, 1] == pytest.approx(9 * 2.8, rel=1e-6)

    def test_subpixel_warp_with_border_wrap(self):
        """3x4 views; ref constant 20; other view column ramp 10+4x (all
        rows, all channels).  Plane dq = 1.5 (in range), left view
        (other_x = q_x - dq):

        q_x=0: other_x=-1.5 -> trunc fx=-1, floor_wgt = 0+1.5 = 1.5 (>1!),
               HandleBorder wraps floor column to 3, ceil to 0:
               lerp = 1.5*22 - 0.5*10 = 28   -> clr |20-28| = 8
               grad lerp = 1.5*0 - 0.5*0 = 0 -> grd 0
               data = 0.1*8 = 0.8
        q_x=1: other_x=-0.5 -> fx = trunc(-0.5) = 0 (C trunc!), floor_wgt
               = 1.5; columns 0 and 1: lerp = 1.5*10 - 0.5*14 = 8
               -> clr 12 -> trunc 10; grad lerp = 1.5*0 - 0.5*8 = -4
               -> grd 4 -> trunc 2; data = 0.1*10 + 0.9*2 = 2.8
        q_x=2: other_x=0.5 -> fx=0, floor_wgt=0.5: lerp = 12 -> clr 8;
               grad lerp = 0.5*8 = 4 -> grd -> 2; data = 0.8 + 1.8 = 2.6

        Ref view constant -> all weights 1; center (1,1) sums columns
        0..2 over 3 rows: 3 * (0.8 + 2.8 + 2.6) = 18.6.

        (Gradient of the other view: [0, 8, 8, 0] -- Sobel [-1,0,1],
        borders 0.)
        """
        ref = jnp.asarray(_const_rgb(3, 4, 20))
        ramp = np.repeat(np.array([10, 14, 18, 22], np.uint8), 3)
        oth = jnp.asarray(np.broadcast_to(ramp.reshape(1, 4, 3),
                                          (3, 4, 3)).copy())
        g_ref, g_oth = gray_gradient(ref), gray_gradient(oth)
        abc = np.zeros((1, 3, 4, 3), np.float32)
        abc[..., 2] = 1.5
        c = np.asarray(grd_fly_cost(ref, oth, g_ref, g_oth,
                                    jnp.asarray(abc), sign=-1, half_wnd=1,
                                    max_dis=4, gamma=10.0))
        assert c[0, 1, 1] == pytest.approx(18.6, rel=1e-5)


def test_pre_vs_fly_saturation_differ():
    """The two cost families saturate DIFFERENTLY: Pre* at max(volume)
    (pre_ss_pc.cc:50-58,101-103), GrdPC at the constant 2.8
    (grd_pc.cc:120-123).  Same scene, same out-of-range plane: 9*40 vs
    9*2.8."""
    img = _const_rgb(3, 3, 20)
    vol = np.full((3, 3, 5), 0.0, np.float32)
    abc = np.zeros((3, 3, 3), np.float32)
    abc[..., 2] = 0.5
    pre = _window_cost(img, vol, 40.0, abc)
    assert pre[1, 1] == pytest.approx(9 * 40.0)
    ref = jnp.asarray(img)
    g = gray_gradient(ref)
    fly = np.asarray(grd_fly_cost(ref, ref, g, g,
                                  jnp.asarray(abc[None]), sign=-1,
                                  half_wnd=1, max_dis=4, gamma=10.0))
    assert fly[0, 1, 1] == pytest.approx(9 * 2.8, rel=1e-6)


def test_scale_weights_tridiagonal():
    """pre_cs_pc.cc:85-109: weights = row 0 of inv(T) with T tridiagonal,
    diag 1+lambda at the ends / 1+2*lambda inside, off-diag -lambda.

    S=2, lambda=0.3: T = [[1.3,-.3],[-.3,1.3]], det = 1.69-0.09 = 1.6,
      inv row 0 = [1.3, 0.3]/1.6 = [0.8125, 0.1875].
    S=3, lambda=0.5: T = [[1.5,-.5,0],[-.5,2,-.5],[0,-.5,1.5]],
      det = 1.5*(3-0.25) - 0.5*(0.75) = 3.75,
      cofactors (col 0 of adj): [2.75, 0.75, 0.25]
      inv row 0 = [11/15, 1/5, 1/15].
    lambda=0 (any S): identity -> [1, 0, ...] (plain single-scale).
    """
    np.testing.assert_allclose(np.asarray(scale_weights(2, 0.3)),
                               [0.8125, 0.1875], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(scale_weights(3, 0.5)),
                               [11 / 15, 1 / 5, 1 / 15], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(scale_weights(5, 0.0)),
                               [1, 0, 0, 0, 0], atol=1e-7)


class TestPlaneParamsGolden:
    """Plane::update_param (plane.h:25-34): a = -nx/nz, b = -ny/nz,
    c = (n . p)/nz, denominator max(|nz|, eps) keeping nz's sign."""

    def test_basic(self):
        # n = (0.6, 0, 0.8), p = (2, 3, 1.5):
        # a = -0.6/0.8 = -0.75, b = 0, c = (1.2 + 0 + 1.2)/0.8 = 3.0
        abc = np.asarray(params_from_normal_point(
            jnp.asarray([0.6, 0.0, 0.8]), jnp.asarray([2.0, 3.0, 1.5])))
        np.testing.assert_allclose(abc, [-0.75, 0.0, 3.0], rtol=1e-6)

    def test_normal_sign_invariance(self):
        # Flipping the normal leaves the plane (and d(x,y)) unchanged
        # because the signed denominator cancels: n=(0.6,0,-0.8) gives
        # a = 0.75, c = (1.2 - 1.2)/(-0.8) = 0; d(2,3) = 1.5 either way.
        abc = np.asarray(params_from_normal_point(
            jnp.asarray([0.6, 0.0, -0.8]), jnp.asarray([2.0, 3.0, 1.5])))
        np.testing.assert_allclose(abc, [0.75, 0.0, 0.0], atol=1e-6)
        assert abc[0] * 2 + abc[1] * 3 + abc[2] == pytest.approx(1.5)

    def test_nz_zero_guard(self):
        # Vertical plane n=(1,0,0): denom = max(0, 1e-8) = 1e-8 ->
        # a = -1e8, c = (1*2)/1e-8 = 2e8; d(2,3) = -2e8 + 2e8 = 0 (finite,
        # no NaN/inf -- the guard's whole purpose, plane.h:27-30).
        abc = np.asarray(params_from_normal_point(
            jnp.asarray([1.0, 0.0, 0.0]), jnp.asarray([2.0, 3.0, 1.5]),
            eps=1e-8))
        np.testing.assert_allclose(abc, [-1e8, 0.0, 2e8], rtol=1e-6)
        assert np.all(np.isfinite(abc))
