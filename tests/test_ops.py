"""Golden-value tests of the core ops against the NumPy oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from crossscalepatchmatch.ops import census, color, cost_volume, grad_cost
from crossscalepatchmatch.ops import gradient, plane, plane_cost, pyramid
from crossscalepatchmatch.ops import scale_weights
from crossscalepatchmatch.config import CSPMConfig, CostMethod

import oracle

RNG = np.random.default_rng(42)


def rand_u8(*shape):
    return RNG.integers(0, 256, shape, dtype=np.uint8)


class TestPlaneMath:
    def test_params_roundtrip(self):
        n = RNG.normal(size=(50, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        pt = RNG.uniform(0, 50, (50, 3))
        abc = plane.params_from_normal_point(jnp.asarray(n), jnp.asarray(pt))
        # disparity at the anchor point equals the anchor's z
        d = plane.disparity_at(abc, pt[:, 0], pt[:, 1])
        np.testing.assert_allclose(d, pt[:, 2], rtol=1e-4, atol=1e-3)

    def test_params_sign_preserving_denominator(self):
        # nz < 0 keeps the sign: matches plane.h:27-30
        n = jnp.array([0.3, 0.2, -0.5])
        pt = jnp.array([4.0, 5.0, 2.0])
        abc = plane.params_from_normal_point(n, pt)
        assert abs(float(plane.disparity_at(abc, pt[0], pt[1])) - 2.0) < 1e-5

    def test_normal_from_params_consistent(self):
        n = np.array([[0.48, -0.6, 0.64]])
        n /= np.linalg.norm(n)
        pt = np.array([[3.0, 7.0, 5.0]])
        abc = plane.params_from_normal_point(jnp.asarray(n), jnp.asarray(pt))
        n2 = plane.normal_from_params(abc)
        np.testing.assert_allclose(np.abs(np.asarray(n2)), np.abs(n),
                                   rtol=1e-5, atol=1e-5)

    def test_random_planes_disparity_in_range(self):
        key = jax.random.PRNGKey(0)
        abc = plane.random_planes(key, (2, 8, 9), 16.0)
        assert abc.shape == (2, 8, 9, 3)
        y = jnp.arange(8.0)[:, None]
        x = jnp.arange(9.0)[None, :]
        d = plane.disparity_at(abc, x, y)
        assert np.all(np.asarray(d) > 0.0)
        assert np.all(np.asarray(d) < 16.0)

    def test_reanchor(self):
        abc = jnp.array([0.1, -0.2, 5.0])
        new = plane.reanchor(abc, 3.0, 4.0, 7.0)
        assert abs(float(plane.disparity_at(new, 3.0, 4.0)) - 7.0) < 1e-6
        assert float(new[0]) == pytest.approx(0.1)
        assert float(new[1]) == pytest.approx(-0.2)


class TestColorGradient:
    def test_gray_u8_matches_oracle(self):
        img = rand_u8(7, 9, 3)
        got = np.asarray(color.rgb_to_gray_u8(jnp.asarray(img)))
        np.testing.assert_array_equal(got, oracle.gray_u8(img))

    def test_sobel_matches_oracle(self):
        img = rand_u8(6, 8, 3)
        g = oracle.gray_f32(img)
        got = np.asarray(gradient.sobel_x_k1(jnp.asarray(g, jnp.float32)))
        np.testing.assert_allclose(got, oracle.sobel_x_k1(g), atol=1e-3)


class TestCostVolumes:
    def test_grd_volume_left(self):
        l, r = rand_u8(5, 12, 3), rand_u8(5, 12, 3)
        got = np.asarray(grad_cost.grd_cost_volume(
            jnp.asarray(l, jnp.float32), jnp.asarray(r, jnp.float32), 4))
        want = oracle.grd_volume(l, r, 4)
        np.testing.assert_allclose(got, want, atol=1e-3)

    def test_grd_volume_right(self):
        l, r = rand_u8(5, 12, 3), rand_u8(5, 12, 3)
        got = np.asarray(grad_cost.grd_cost_volume(
            jnp.asarray(l, jnp.float32), jnp.asarray(r, jnp.float32), 4,
            right=True))
        want = oracle.grd_volume(l, r, 4, right=True)
        np.testing.assert_allclose(got, want, atol=1e-3)

    def test_census_volume_left(self):
        l, r = rand_u8(10, 14), rand_u8(10, 14)
        got = np.asarray(census.census_cost_volume(
            jnp.asarray(l), jnp.asarray(r), 5))
        want = oracle.census_volume(l, r, 5)
        np.testing.assert_array_equal(got, want)

    def test_census_volume_right(self):
        l, r = rand_u8(10, 14), rand_u8(10, 14)
        got = np.asarray(census.census_cost_volume(
            jnp.asarray(l), jnp.asarray(r), 5, right=True))
        want = oracle.census_volume(l, r, 5, right=True)
        np.testing.assert_array_equal(got, want)

    def test_census_small_window(self):
        l, r = rand_u8(8, 9), rand_u8(8, 9)
        got = np.asarray(census.census_cost_volume(
            jnp.asarray(l), jnp.asarray(r), 3, wnd=3))
        want = oracle.census_volume(l, r, 3, wnd=3)
        np.testing.assert_array_equal(got, want)


class TestPyramid:
    def test_pyrdown_shape(self):
        img = rand_u8(11, 13, 3)
        out = pyramid.pyr_down(jnp.asarray(img))
        assert out.shape == (6, 7, 3)
        assert out.dtype == jnp.uint8

    def test_pyrdown_constant_preserved(self):
        img = np.full((10, 10, 3), 77, np.uint8)
        out = np.asarray(pyramid.pyr_down(jnp.asarray(img)))
        np.testing.assert_array_equal(out, np.full((5, 5, 3), 77))

    def test_reflect101(self):
        x = jnp.arange(5.0)
        got = np.asarray(pyramid._reflect101_pad(x, 0, 2))
        np.testing.assert_array_equal(got, [2, 1, 0, 1, 2, 3, 4, 3, 2])


class TestScaleWeights:
    def test_lambda_zero(self):
        w = scale_weights.scale_weights(5, 0.0)
        np.testing.assert_allclose(w, [1, 0, 0, 0, 0], atol=1e-7)

    def test_row_sums_to_one(self):
        # (I + lambda L) has row sums 1 => inverse rows sum to 1
        w = scale_weights.scale_weights(5, 0.3)
        assert w.sum() == pytest.approx(1.0, abs=1e-6)
        assert np.all(w > 0)

    def test_matches_direct_inverse(self):
        lam = 2.0
        m = np.array([[1 + lam, -lam, 0],
                      [-lam, 1 + 2 * lam, -lam],
                      [0, -lam, 1 + lam]])
        want = np.linalg.inv(m)[0]
        np.testing.assert_allclose(scale_weights.scale_weights(3, lam), want,
                                   rtol=1e-5)


class TestPlaneCost:
    def _setup(self, h=7, w=9, max_dis=5):
        img = rand_u8(h, w, 3)
        vol = RNG.uniform(0, 3, (h, w, max_dis + 1)).astype(np.float32)
        mc = float(vol.max())
        key = jax.random.PRNGKey(1)
        abc = plane.random_planes(key, (2, h, w), float(max_dis))
        return img, vol, mc, abc

    def test_ss_matches_oracle(self):
        img, vol, mc, abc = self._setup()
        got = np.asarray(plane_cost.window_plane_cost(
            jnp.asarray(img), jnp.asarray(vol), jnp.float32(mc), abc,
            half_wnd=2, max_dis=5, gamma=10.0))
        for k in range(2):
            want = oracle.plane_cost_ss(img, vol, mc, np.asarray(abc[k]),
                                        half_wnd=2, max_dis=5)
            np.testing.assert_allclose(got[k], want, rtol=2e-3, atol=2e-3)

    def test_cs_matches_oracle(self):
        h, w, max_dis = 12, 16, 8
        img0 = rand_u8(h, w, 3)
        img1 = rand_u8((h + 1) // 2, (w + 1) // 2, 3)
        vol0 = RNG.uniform(0, 3, (h, w, max_dis + 1)).astype(np.float32)
        vol1 = RNG.uniform(0, 3, ((h + 1) // 2, (w + 1) // 2,
                                  max_dis // 2 + 1)).astype(np.float32)
        mc = [float(vol0.max()), float(vol1.max())]
        wgts = [0.7, 0.3]
        key = jax.random.PRNGKey(2)
        abc = plane.random_planes(key, (1, h, w), float(max_dis))
        got = np.asarray(plane_cost.cross_scale_plane_cost(
            [jnp.asarray(img0), jnp.asarray(img1)],
            [jnp.asarray(vol0), jnp.asarray(vol1)],
            [jnp.float32(m) for m in mc], wgts, abc,
            half_wnd=2, max_dis=max_dis, gamma=10.0))
        want = oracle.plane_cost_cs([img0, img1], [vol0, vol1], mc, wgts,
                                    np.asarray(abc[0]), half_wnd=2,
                                    max_dis=max_dis)
        np.testing.assert_allclose(got[0], want, rtol=2e-3, atol=2e-3)


class TestVolumeData:
    def test_build_volume_data_shapes(self):
        cfg = CSPMConfig(max_dis=8, dis_scale=8, use_cs=True, scale_num=3,
                         cost_method=CostMethod.GRD)
        l, r = rand_u8(16, 20, 3), rand_u8(16, 20, 3)
        vd = cost_volume.build_volume_data(jnp.asarray(l), jnp.asarray(r), cfg)
        assert len(vd.vols) == 3
        assert vd.vols[0].shape == (2, 16, 20, 9)
        assert vd.vols[1].shape == (2, 8, 10, 5)
        assert vd.vols[2].shape == (2, 4, 5, 3)
        assert vd.imgs[1].shape == (2, 8, 10, 3)


class TestLab:
    def test_lab_goldens(self):
        """Hand-derived u8 Lab values from the documented OpenCV 8U
        formula (f64 evaluation): BGR in, (L*255/100, a+128, b+128) out.
        Pins the conversion the USE_LAB_WGT weight variant reads
        (grd_pc.cc:31-35,105-109)."""
        bgr = jnp.array([[[0, 0, 0], [255, 255, 255], [0, 0, 255],
                          [0, 255, 0], [255, 0, 0], [128, 128, 128],
                          [40, 120, 200]]], jnp.uint8)
        want = np.array([[[0, 128, 128], [255, 128, 128], [136, 208, 195],
                          [224, 42, 211], [82, 207, 20], [194, 128, 128],
                          [196, 136, 171]]], np.uint8)
        got = np.asarray(color.bgr_to_lab_u8(bgr)).astype(np.int32)
        # f32 evaluation may round a borderline value one step from the
        # f64 golden
        assert np.abs(got - want.astype(np.int32)).max() <= 1

    def test_lab_gray_axis(self):
        """Any gray pixel maps to a = b = 128 (neutral chroma) with L
        monotone in intensity."""
        g = jnp.arange(0, 256, 15, jnp.uint8)
        bgr = jnp.stack([g, g, g], axis=-1)[None]
        lab = np.asarray(color.bgr_to_lab_u8(bgr))[0]
        np.testing.assert_array_equal(lab[:, 1], 128)
        np.testing.assert_array_equal(lab[:, 2], 128)
        assert np.all(np.diff(lab[:, 0].astype(np.int32)) >= 0)
        assert lab[0, 0] == 0 and lab[-1, 0] == 255
