"""End-to-end engine tests on synthetic stereo with exact ground truth."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from crossscalepatchmatch import CSPMConfig, CostMethod
from crossscalepatchmatch.data import make_pair
from crossscalepatchmatch.metrics import bad_pixel_rate, epe
from crossscalepatchmatch.models import patchmatch as pm
from crossscalepatchmatch.models import postprocess as pp
from crossscalepatchmatch.models.pipeline import run_pair_np


SMALL = dict(h=48, w=64, max_dis=12, seed=3)


def small_cfg(**kw):
    base = dict(max_dis=12, dis_scale=16, wnd_size=11,
                cost_method=CostMethod.GRD, use_cs=False, use_pp=False)
    base.update(kw)
    return CSPMConfig(**base)


class TestEndToEnd:
    def test_plain_patchmatch_recovers_disparity(self):
        pair = make_pair(**SMALL)
        cfg = small_cfg()
        out = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp = out["dis"][0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        # random planes start ~100% bad; a working optimizer gets most
        # non-occluded pixels right
        assert bad < 0.15, f"bad-pixel rate too high: {bad:.3f}"

    def test_right_view_also_converges(self):
        pair = make_pair(**SMALL)
        cfg = small_cfg()
        out = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp_r = out["dis"][1].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp_r, pair.disp_right, pair.valid_right, 1.0)
        assert bad < 0.15, f"right bad-pixel rate too high: {bad:.3f}"

    def test_census_cost_method(self):
        pair = make_pair(**SMALL)
        cfg = small_cfg(cost_method=CostMethod.CEN)
        out = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp = out["dis"][0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        assert bad < 0.2, f"census bad-pixel rate too high: {bad:.3f}"

    def test_cross_scale(self):
        pair = make_pair(**SMALL)
        cfg = small_cfg(use_cs=True, scale_num=3, reg_lambda=0.3)
        out = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp = out["dis"][0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        assert bad < 0.2, f"cross-scale bad-pixel rate too high: {bad:.3f}"

    def test_postprocessing_improves_or_holds(self):
        pair = make_pair(**SMALL)
        out_raw = run_pair_np(pair.left, pair.right, small_cfg(), seed=0)
        out_pp = run_pair_np(pair.left, pair.right, small_cfg(use_pp=True),
                             seed=0)
        s = small_cfg().dis_scale
        # evaluate over ALL pixels: pp should fix occluded regions
        bad_raw = bad_pixel_rate(out_raw["dis"][0] / s, pair.disp_left, None)
        bad_pp = bad_pixel_rate(out_pp["dis"][0] / s, pair.disp_left, None)
        assert bad_pp <= bad_raw + 0.02

    def test_standalone_view_propagation(self):
        # merge_view=False keeps view propagation as its own adoption step
        # (the reference's step order, cs_patchmatch.cc:61-99); it must
        # converge like the merged default
        pair = make_pair(**SMALL)
        cfg = small_cfg(merge_view=False)
        out = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp = out["dis"][0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        assert bad < 0.15, f"merge_view=False bad rate too high: {bad:.3f}"

    def test_deterministic_given_seed(self):
        pair = make_pair(**SMALL)
        cfg = small_cfg()
        a = run_pair_np(pair.left, pair.right, cfg, seed=7)
        b = run_pair_np(pair.left, pair.right, cfg, seed=7)
        np.testing.assert_array_equal(a["dis"], b["dis"])

    def test_batched_pairs_match_single_runs(self):
        # run_pairs (single-chip batch serving) must equal per-pair
        # run_pair bit-for-bit, each pair under its own seed
        from crossscalepatchmatch.models.pipeline import (run_pair,
                                                              run_pairs)
        p0 = make_pair(**SMALL)
        p1 = make_pair(**{**SMALL, "seed": 9, "n_fg": 3})
        cfg = small_cfg()
        ls = jnp.stack([jnp.asarray(p0.left), jnp.asarray(p1.left)])
        rs = jnp.stack([jnp.asarray(p0.right), jnp.asarray(p1.right)])
        seeds = jnp.array([3, 11], jnp.int32)
        batched = run_pairs(ls, rs, seeds, cfg)
        for i in range(2):
            single = run_pair(ls[i], rs[i], seeds[i], cfg)
            for k in ("dis", "abc", "cost", "valid"):
                np.testing.assert_array_equal(np.asarray(batched[k][i]),
                                              np.asarray(single[k]), err_msg=k)

    def test_rank_exact_adoption_converges(self):
        # rank+exact: iterations 0..max_iter-2 adopt on quadrant ranking
        # costs, the final iteration on exact costs
        pair = make_pair(**SMALL)
        cfg = small_cfg(adopt_mode="rank+exact")
        out = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp = out["dis"][0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        assert bad < 0.15, f"rank+exact bad-pixel rate too high: {bad:.3f}"
        # the held cost must be in exact units after the final iteration:
        # re-evaluating the returned planes exactly reproduces it
        from crossscalepatchmatch.models import patchmatch as pm2
        from crossscalepatchmatch.ops.cost_volume import (
            build_volume_data)
        vd = build_volume_data(jnp.asarray(pair.left),
                               jnp.asarray(pair.right), cfg)
        cost_fn = pm2.make_cost_fn(cfg, vd)
        exact = np.asarray(cost_fn(jnp.asarray(out["abc"])[:, None])[:, 0])
        np.testing.assert_allclose(out["cost"], exact, rtol=1e-5, atol=1e-4)

    def test_rank_adoption_modes_validate(self):
        with pytest.raises(ValueError):
            small_cfg(adopt_mode="fastest")

    @pytest.mark.slow
    def test_deferred_cost_entry_matches_refresh(self):
        """The deferred-cost entry (held cost invalidated to +inf, current
        plane prepended to the first exact sweep) must reproduce the
        refresh-style trajectory (standalone K=1 exact evaluation of the
        held planes) plane-for-plane.  Both trajectories are composed
        here as unrolled loops so only the entry style differs."""
        from crossscalepatchmatch.ops.cost_volume import (
            build_volume_data)
        pair = make_pair(**SMALL)
        h, w = SMALL["h"], SMALL["w"]

        for n_rank_cfg in ("exact", "rank+exact"):
            cfg = small_cfg(adopt_mode=n_rank_cfg)
            vd = build_volume_data(jnp.asarray(pair.left),
                                   jnp.asarray(pair.right), cfg)
            cost_fn, sparse_fn = pm.make_cost_fns(cfg, vd)
            key = jax.random.PRNGKey(5)
            k_init, _ = jax.random.split(key)
            keys = pm.iteration_keys(key, cfg)
            n_rank = cfg.rank_iters if n_rank_cfg == "rank+exact" else 0

            def rank_phase():
                st = pm.init_state(k_init, (h, w),
                                   sparse_fn if n_rank else None, cfg)
                for i in range(n_rank):
                    st = pm.iteration_step(st, keys[i], sparse_fn, cfg)
                return st

            # refresh style: standalone K=1 exact eval of the held planes
            st_a = rank_phase()
            st_a = pm.PMState(abc=st_a.abc,
                              cost=cost_fn(st_a.abc[:, None])[:, 0])
            for i in range(n_rank, cfg.max_iter):
                st_a = pm.iteration_step(st_a, keys[i], cost_fn, cfg,
                                         sparse_fn)

            # deferred style: +inf held cost, include_current first sweep
            st_b = rank_phase()
            st_b = pm.PMState(abc=st_b.abc,
                              cost=jnp.full_like(st_b.cost, jnp.inf))
            for i in range(n_rank, cfg.max_iter):
                st_b = pm.iteration_step(st_b, keys[i], cost_fn, cfg,
                                         sparse_fn,
                                         include_current=i == n_rank)

            np.testing.assert_array_equal(np.asarray(st_a.abc),
                                          np.asarray(st_b.abc))
            # held costs may differ by fusion-order ulps on tie pixels
            np.testing.assert_allclose(np.asarray(st_a.cost),
                                       np.asarray(st_b.cost),
                                       rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError):
            # pure rank adoption needs the quadrant prescreen
            small_cfg(adopt_mode="rank", prescreen_mode="window")
        # rank+exact without the quadrant prescreen degrades gracefully
        # to all-exact adoption (e.g. the no-volume fly path)
        cfg = small_cfg(adopt_mode="rank+exact", prescreen_stride=1)
        assert not cfg.rank_enabled and cfg.rank_iters == 0
        assert small_cfg(adopt_mode="rank+exact").rank_iters == 1


class TestPostprocessUnits:
    def test_lr_check_consistent_input_is_valid(self):
        cfg = small_cfg(dis_scale=4)
        h, w = 6, 16
        d = 3
        dis = np.zeros((2, h, w), np.uint8)
        dis[:] = d * cfg.dis_scale
        valid = np.asarray(pp.lr_check(jnp.asarray(dis), cfg))
        # interior pixels with identical constant disparity are consistent
        assert valid[0, :, d:].all()
        # left-border left-view pixels warp out of range -> invalid
        assert not valid[0, :, :d].any()

    def test_lr_check_zero_disparity_invalid(self):
        cfg = small_cfg()
        dis = np.zeros((2, 4, 8), np.uint8)
        valid = np.asarray(pp.lr_check(jnp.asarray(dis), cfg))
        assert not valid.any()

    def test_fill_invalid_takes_min_side(self):
        cfg = small_cfg(dis_scale=1, max_dis=12)
        h, w = 1, 8
        dis = np.zeros((2, h, w), np.uint8)
        abc = np.zeros((2, h, w, 3), np.float32)
        # left half plane d=10, right half d=4, middle invalid
        abc[:, :, :4, 2] = 10.0
        abc[:, :, 4:, 2] = 4.0
        dis[:, :, :4] = 10
        dis[:, :, 4:] = 4
        valid = np.zeros((2, h, w), bool)
        valid[:, :, 1] = True   # valid left anchor (d=10)
        valid[:, :, 6] = True   # valid right anchor (d=4)
        out = np.asarray(pp.fill_invalid(jnp.asarray(dis), jnp.asarray(abc),
                                         jnp.asarray(valid), cfg))
        # invalid pixels between anchors take the smaller (background) disp
        np.testing.assert_array_equal(out[0, 0, 2:6], [4, 4, 4, 4])
        # left of the left anchor: only left anchor reachable? x=0 has
        # l_first at x=1? no -- nearest valid to the left of x=0 doesn't
        # exist; right-nearest is x=1 (d=10): one-sided fill
        assert out[0, 0, 0] == 10

    def test_weighted_median_majority_wins(self):
        cfg = small_cfg(wnd_size=5, dis_scale=1)
        h, w = 7, 7
        img = np.full((2, h, w, 3), 100, np.uint8)
        dis = np.full((2, h, w), 8, np.uint8)
        dis[:, 3, 3] = 200            # outlier at center
        valid = np.ones((2, h, w), bool)
        valid[:, 3, 3] = False
        out = np.asarray(pp.weighted_median(jnp.asarray(dis), jnp.asarray(img),
                                            jnp.asarray(valid), cfg))
        assert out[0, 3, 3] == 8      # replaced by unanimous neighbors
        assert out[0, 0, 0] == 8      # valid pixels untouched


class TestAdopt:
    def test_adopt_strict_improvement_only(self):
        st = pm.PMState(abc=jnp.zeros((2, 2, 2, 3)),
                        cost=jnp.full((2, 2, 2), 5.0))
        cand_abc = jnp.ones((2, 1, 2, 2, 3))
        cand_cost = jnp.full((2, 1, 2, 2), 5.0)  # equal -> no adoption
        out = pm._adopt(st, cand_abc, cand_cost)
        np.testing.assert_array_equal(np.asarray(out.abc),
                                      np.zeros((2, 2, 2, 3)))
        cand_cost = cand_cost.at[0, 0, 0, 0].set(4.0)
        out = pm._adopt(st, cand_abc, cand_cost)
        assert np.asarray(out.abc)[0, 0, 0, 0] == 1.0
        assert np.asarray(out.cost)[0, 0, 0] == 4.0
        assert np.asarray(out.cost)[1, 0, 0] == 5.0


class TestWarmStart:
    def test_sequence_warm_start_holds_quality(self):
        from crossscalepatchmatch.models.pipeline import run_sequence_np

        pair = make_pair(**SMALL)
        cfg = small_cfg(max_iter=2)
        # static scene "video": warm frames hold the cold frame's quality
        # (total cost is monotone under strict-improvement adoption; the
        # bad-pixel rate may wiggle within noise)
        frames = [(pair.left, pair.right)] * 3
        bads = []
        for out in run_sequence_np(frames, cfg, seed=0, warm_iters=1):
            disp = out["dis"][0].astype(np.float32) / cfg.dis_scale
            bads.append(bad_pixel_rate(disp, pair.disp_left,
                                       pair.valid_left, 1.0))
        assert bads[1] <= bads[0] + 0.005, bads
        assert bads[2] <= bads[0] + 0.005, bads

    def test_warm_start_cost_never_worse(self):
        from crossscalepatchmatch.models.pipeline import (run_pair_np,
                                                              run_pair_warm)

        pair = make_pair(**SMALL)
        cfg = small_cfg(max_iter=2)
        cold = run_pair_np(pair.left, pair.right, cfg, seed=0)
        warm = run_pair_warm(jnp.asarray(pair.left), jnp.asarray(pair.right),
                             jnp.int32(1), jnp.asarray(cold["abc"]), cfg,
                             warm_iters=1)
        # strict-improvement adoption: total cost is monotone per pixel
        assert (np.asarray(warm["cost"]) <= cold["cost"] + 1e-5).all()


class TestLabWeights:
    """USE_LAB_WGT capability (grd_pc.h:25): ASW weights on the CIE Lab
    conversion; data terms and post-processing stay BGR/gradient."""

    def test_lab_weights_volume_path_converges(self):
        pair = make_pair(**SMALL)
        cfg = small_cfg(use_lab_weights=True, use_pp=True)
        out = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp = out["dis"][0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        assert bad < 0.15, f"lab-weight bad-pixel rate too high: {bad:.3f}"

    def test_lab_weights_change_the_costs(self):
        """The Lab weight image must actually reach the evaluator: cost
        fields under BGR vs Lab weights differ (same volume, same
        planes)."""
        from crossscalepatchmatch.ops.cost_volume import (
            build_volume_data)
        pair = make_pair(**SMALL)
        key = jax.random.PRNGKey(0)
        abc2 = jax.random.uniform(key, (2, 1, 48, 64, 3), jnp.float32,
                                  -0.2, 0.2).at[..., 2].add(5.0)
        costs = []
        for lab in (False, True):
            cfg = small_cfg(use_lab_weights=lab)
            vd = build_volume_data(jnp.asarray(pair.left),
                                   jnp.asarray(pair.right), cfg)
            cost_fn, _ = pm.make_cost_fns(cfg, vd)
            costs.append(np.asarray(cost_fn(abc2)))
        assert not np.allclose(costs[0], costs[1])

    def test_lab_weights_literal_fly_path(self):
        """The literal jnp on-the-fly path accepts Lab weights (the exact
        code path the reference's toggle lives in, grd_pc.cc:80-110)."""
        pair = make_pair(h=32, w=48, max_dis=8, seed=3)
        cfg = small_cfg(max_dis=8, wnd_size=9, precompute_volume=False,
                        use_lab_weights=True, use_pallas=False,
                        adopt_mode="exact", prescreen_stride=1)
        out = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp = out["dis"][0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        assert bad < 0.25, f"literal-fly lab bad-pixel too high: {bad:.3f}"
