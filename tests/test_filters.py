"""Golden tests for ops.filters against naive NumPy oracles.

Oracle loops mirror the documented behavior of the reference filters
(ca_filter/GuidedFilter.cpp, ca_filter/BilateralFilter.cpp, ctmf.c via
commfunc.cc MedianFilter) on tiny inputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from crossscalepatchmatch.ops import filters


def np_box_filter(x, r):
    h, w = x.shape
    out = np.zeros_like(x, np.float64)
    for y in range(h):
        for xx in range(w):
            y0, y1 = max(0, y - r), min(h, y + r + 1)
            x0, x1 = max(0, xx - r), min(w, xx + r + 1)
            out[y, xx] = x[y0:y1, x0:x1].sum()
    return out


def np_bilateral(guide, p, wnd, sig_clr):
    h, w = p.shape
    half = wnd // 2
    sig_sp = wnd / 2.0
    out = np.zeros_like(p, np.float64)
    for y in range(h):
        for x in range(w):
            s = sw = 0.0
            for dy in range(-half, half + 1):
                for dx in range(-half, half + 1):
                    qy = (y + dy) % h
                    qx = (x + dx) % w
                    if guide.ndim == 3:
                        clr = np.mean(np.abs(guide[qy, qx] - guide[y, x]))
                    else:
                        clr = abs(guide[qy, qx] - guide[y, x])
                    wgt = np.exp(-(dx * dx + dy * dy) / (sig_sp * sig_sp)
                                 - clr * clr / (sig_clr * sig_clr))
                    s += wgt * p[qy, qx]
                    sw += wgt
            out[y, x] = s / sw
    return out


def np_median_u8(img, r):
    h, w = img.shape
    pad = np.pad(img, r, mode="edge")
    out = np.zeros_like(img)
    for y in range(h):
        for x in range(w):
            out[y, x] = np.median(pad[y:y + 2 * r + 1, x:x + 2 * r + 1])
    return out


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_box_filter_matches_clipped_window_sum(rng):
    x = rng.normal(size=(11, 13)).astype(np.float32)
    got = np.asarray(filters.box_filter(jnp.asarray(x), 3))
    np.testing.assert_allclose(got, np_box_filter(x, 3), rtol=1e-5,
                               atol=1e-5)


def test_box_filter_batched(rng):
    x = rng.normal(size=(2, 9, 10)).astype(np.float32)
    got = np.asarray(filters.box_filter(jnp.asarray(x), 2))
    for b in range(2):
        np.testing.assert_allclose(got[b], np_box_filter(x[b], 2),
                                   rtol=1e-5, atol=1e-5)


def test_guided_filter_gray_flat_regions(rng):
    # On a constant guide: var=cov=0, a=0, b=mean_p, so the output is the
    # clipped-window mean applied twice (q = bf(b)).
    p = rng.uniform(size=(12, 14)).astype(np.float32)
    guide = np.full((12, 14), 0.5, np.float32)
    got = np.asarray(filters.guided_filter(jnp.asarray(guide),
                                           jnp.asarray(p), radius=3))
    n = np_box_filter(np.ones_like(p, np.float64), 3)
    mean_p = np_box_filter(p, 3) / n
    want = np_box_filter(mean_p, 3) / n
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_guided_filter_color_edge_preserving(rng):
    # A step edge in both guide and signal must be preserved much better
    # than by a plain box mean.
    h, w = 16, 24
    guide = np.zeros((h, w, 3), np.float32)
    guide[:, w // 2:] = 1.0
    p = guide[..., 0].copy()
    noisy = p + rng.normal(scale=0.05, size=p.shape).astype(np.float32)
    got = np.asarray(filters.guided_filter(jnp.asarray(guide),
                                           jnp.asarray(noisy), radius=4,
                                           eps=1e-4))
    edge_err = np.abs(got - p)[:, w // 2 - 1:w // 2 + 1].mean()
    assert edge_err < 0.08, edge_err


def test_bilateral_filter_matches_oracle(rng):
    guide = rng.uniform(size=(8, 9, 3)).astype(np.float32)
    p = rng.uniform(size=(8, 9)).astype(np.float32)
    got = np.asarray(filters.bilateral_filter(jnp.asarray(guide),
                                              jnp.asarray(p), wnd=5))
    want = np_bilateral(guide.astype(np.float64), p.astype(np.float64),
                        5, 0.03)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bilateral_gray_guide(rng):
    guide = rng.uniform(size=(7, 8)).astype(np.float32)
    p = rng.uniform(size=(7, 8)).astype(np.float32)
    got = np.asarray(filters.bilateral_filter(jnp.asarray(guide),
                                              jnp.asarray(p), wnd=3))
    want = np_bilateral(guide.astype(np.float64), p.astype(np.float64),
                        3, 0.03)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_median_filter_matches_numpy(rng):
    img = rng.integers(0, 256, size=(13, 17), dtype=np.uint8)
    got = np.asarray(filters.median_filter_u8(jnp.asarray(img), 2))
    want = np_median_u8(img, 2)
    np.testing.assert_array_equal(got, want)


def test_median_filter_channels(rng):
    img = rng.integers(0, 256, size=(6, 7, 3), dtype=np.uint8)
    got = np.asarray(filters.median_filter_u8(jnp.asarray(img), 1))
    for c in range(3):
        np.testing.assert_array_equal(got[..., c],
                                      np_median_u8(img[..., c], 1))


def test_volume_aggregation_touches_inner_slices_only(rng):
    vol = rng.uniform(size=(10, 12, 6)).astype(np.float32)
    got = np.asarray(filters.box_filter_volume(jnp.asarray(vol), radius=1))
    np.testing.assert_array_equal(got[..., 0], vol[..., 0])
    np.testing.assert_array_equal(got[..., 5], vol[..., 5])
    for d in range(1, 5):
        np.testing.assert_allclose(got[..., d], np_box_filter(
            vol[..., d].astype(np.float64), 1), rtol=1e-5, atol=1e-5)


def test_aggregator_dispatch_runs():
    from crossscalepatchmatch.config import Aggregator, CSPMConfig
    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.ops.cost_volume import build_volume_data

    pair = make_pair(h=24, w=32, max_dis=6, seed=3)
    for agg in (Aggregator.BOX, Aggregator.GF, Aggregator.BF):
        cfg = CSPMConfig(max_dis=6, dis_scale=16, wnd_size=7,
                         aggregator=agg)
        vd = build_volume_data(jnp.asarray(pair.left),
                               jnp.asarray(pair.right), cfg)
        vol = np.asarray(vd.vols[0])
        assert np.isfinite(vol).all(), agg
        assert vol.shape == (2, 24, 32, 7), agg
