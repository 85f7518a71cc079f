"""Analytic work model sanity (utils.roofline)."""

import numpy as np

from crossscalepatchmatch import CSPMConfig
from crossscalepatchmatch.utils.roofline import (count_plane_cost_work,
                                                     pipeline_flops)


def _cfg(**kw):
    base = dict(max_dis=60, dis_scale=4)
    base.update(kw)
    return CSPMConfig(**base)


def test_flops_positive_and_ordered():
    fl = pipeline_flops(_cfg(), 375, 450)
    assert fl["semantic_flops"] > 0 and fl["evaluations"] > 0
    assert fl["transcendentals"] > 0
    # the parts add up, and every part of the default schedule is present
    parts = fl["exact_flops"] + fl["rank_flops"] + fl["build_flops"]
    assert np.isclose(parts, fl["semantic_flops"])
    assert min(fl["exact_flops"], fl["rank_flops"], fl["build_flops"]) > 0
    # all-exact adoption does more exact window work than rank+exact
    ex = pipeline_flops(_cfg(adopt_mode="exact"), 375, 450)
    assert ex["exact_flops"] > fl["exact_flops"]


def test_flops_scale_with_area_and_disparity():
    small = pipeline_flops(_cfg(), 100, 100)
    big = pipeline_flops(_cfg(), 200, 200)
    # per-pixel work model: 4x the pixels = 4x the flops
    assert np.isclose(big["semantic_flops"] / small["semantic_flops"], 4.0)
    lo_d = pipeline_flops(_cfg(max_dis=16, dis_scale=16), 100, 100)
    hi_d = pipeline_flops(_cfg(max_dis=128, dis_scale=1), 100, 100)
    # the quadrant build multiply-adds over the full disparity depth
    assert hi_d["build_flops"] > lo_d["build_flops"]
    assert hi_d["semantic_flops"] > lo_d["semantic_flops"]


def test_exact_mode_counts_more_full_launches():
    # rank+exact replaces most exact launches with quadrant rankings
    rank = count_plane_cost_work(_cfg())
    exact = count_plane_cost_work(_cfg(adopt_mode="exact"))
    assert rank["rank_cands"] > 0
    assert exact["ocu"] > rank["ocu"]
    assert exact["launches"] > rank["launches"]


def test_default_schedule_launch_economy():
    """Pin the launch structure of the production default (cones config):
    rank phase has zero exact launches; the deferred-cost entry leaves 5
    full-window launches per exact iteration (two sweep winners, the
    standalone view propagation, two refinement-stage winners) --
    merge_view is OFF by default since round 3 (it broke the hardware
    parity bound, see config.merge_view)."""
    c = count_plane_cost_work(_cfg())       # max_iter=3, exact_iters=2
    assert c["launches"] == 2 * 5            # 2 exact iterations
    # OCU: exact iter 1 evaluates K=2 (winner+deferred current), K=1
    # (winner), 1 (view), 1, 1; iter 2: 1, 1, 1, 1, 1 -> 11 x wnd^2
    assert c["ocu"] == 11 * 35 * 35
    # merge_view folds the view candidate into the last sweep's launch
    c2 = count_plane_cost_work(_cfg(merge_view=True))
    assert c2["launches"] == 2 * 4
    assert c2["ocu"] == c["ocu"]             # same samples, fewer launches
