"""Work accounting for the window-cost hot path.

An analytic count of the pipeline's plane-cost work: how many (center,
window-offset, candidate) samples a run evaluates, and the SEMANTIC
operations they imply (the 2-tap lerp the reference semantics require,
pre_ss_pc.cc:99-111), plus the quadrant ranking and its one-time build.
The counts describe the schedule, not a device: divide them by a measured
device time to get an achieved rate.
"""

from __future__ import annotations

from typing import Dict

from ..config import CSPMConfig

# semantic ops per (center, offset, candidate): plane eval at q (2 fma),
# trunc+range test (~3), two lerp weights (~6), 2-tap lerp mac (4),
# weighted accumulate (2)
SEMANTIC_OPS_PER_SAMPLE = 17
# ASW weight ops per (center, offset) per evaluation: 3 u8 abs-diffs,
# 2 adds, scale (exp counted separately as a transcendental)
WEIGHT_OPS_PER_OFFSET = 6
# quadrant ranking ops per (center, candidate, quadrant anchor): plane
# eval at the anchor (2 fma), trunc+range test (~3), 2-tap lerp (4),
# saturation select + accumulate (~2)
RANK_OPS_PER_ANCHOR = 13


def count_plane_cost_work(cfg: CSPMConfig) -> Dict[str, float]:
    """Per-pixel-per-view evaluation counts of one run_pair pipeline.

    Mirrors models.patchmatch.patchmatch's launch structure, including
    the schedule's launch-economy features: rank-phase iterations adopt
    on quadrant rankings (no exact launches at all), cfg.merge_view
    folds the view candidate into the last sweep's launch, and the
    deferred-cost entry replaces the init/boundary K=1 exact launch with
    one extra candidate in the first exact sweep.  Returns counts in
    units of window-offset-candidate samples (OCU) and exp() calls per
    pixel per view.
    """
    wnd = cfg.wnd_size
    full_offs = wnd * wnd
    n_str = len(range(-cfg.half_wnd, cfg.half_wnd + 1,
                      max(cfg.prescreen_stride, 1)))
    sparse_offs = n_str * n_str
    volume_rank = (cfg.prescreen_stride > 1
                   and cfg.prescreen_mode == "volume")
    # the window prescreen is single-scale only; the volume prescreen
    # also serves cross-scale configs (fine-level ranking)
    prescreen = cfg.prescreen_stride > 1 and (not cfg.use_cs or volume_rank)
    k_stencil = 4 + (4 if cfg.far_offsets else 0)
    r = len(cfg.refinement_schedule())
    if cfg.batch_refine:
        stages = max(1, min(cfg.refine_stages, r))
        per = -(-r // stages)
        stage_ks = [min(per, r - s0) for s0 in range(0, r, per)]
    else:
        stage_ks = [1] * r

    scales = 1
    if cfg.use_cs:
        # the window is evaluated at every pyramid level (unscaled window,
        # pre_cs_pc.cc:135): same offset count per level
        scales = cfg.scale_num

    n_rank = cfg.rank_iters
    n_exact = cfg.max_iter - n_rank
    merge = cfg.merge_view and cfg.prop_sweeps > 0
    defer = cfg.prop_sweeps > 0 and n_exact > 0

    rank_cands = 0.0  # candidates ranked on the quadrant volumes
    launches = []    # (K, offsets) per kernel launch

    def launch(k, offs):
        launches.append((k, offs))

    # init: ranking eval (rank phase), deferred (exact entry), or K=1
    if n_rank:
        rank_cands += 1
    elif not defer:
        launch(1, full_offs)

    # rank-phase iterations: every adoption (sweeps, view candidate,
    # refinement stages) on the quadrant ranking -- zero exact launches
    rank_cands += n_rank * (cfg.prop_sweeps * k_stencil + 1
                            + sum(stage_ks))

    # rank -> exact boundary: exact refresh unless deferred
    if n_rank and n_exact and not defer:
        launch(1, full_offs)

    for it in range(n_exact):
        for s in range(cfg.prop_sweeps):
            k_extra = (1 if (defer and it == 0 and s == 0) else 0) \
                + (1 if (merge and s == cfg.prop_sweeps - 1) else 0)
            if prescreen:
                if volume_rank:
                    rank_cands += k_stencil
                else:
                    launch(k_stencil, sparse_offs)
                launch(1 + k_extra, full_offs)     # winner (+ riders)
            else:
                launch(k_stencil + k_extra, full_offs)
        if not merge:
            launch(1, full_offs)                   # view propagation
        for k in stage_ks:
            if prescreen and k > 1:
                if volume_rank:
                    rank_cands += k
                else:
                    launch(k, sparse_offs)
                launch(1, full_offs)
            else:
                launch(k, full_offs)

    ocu = 0.0        # kernel (offset, candidate) samples
    exps = 0.0       # kernel weight exp() evaluations (shared across K)
    for k, offs in launches:
        ocu += k * offs * scales
        exps += offs * scales
    # quadrant-volume build: one strided-window aggregation pass per pair
    build_offs = sparse_offs if volume_rank else 0.0
    return {"ocu": ocu, "exps": exps, "launches": len(launches),
            "rank_cands": rank_cands, "build_offs": build_offs}


def pipeline_flops(cfg: CSPMConfig, h: int, w: int) -> Dict[str, float]:
    """Semantic operation totals for one stereo pair (both views)."""
    counts = count_plane_cost_work(cfg)
    px = h * w * 2   # both views
    d = cfg.max_dis + 1
    exact = (counts["ocu"] * px * SEMANTIC_OPS_PER_SAMPLE
             + counts["exps"] * px * WEIGHT_OPS_PER_OFFSET)
    # quadrant-volume prescreen (prescreen_mode="volume"): 4 anchor lerps
    # per ranked candidate, plus the one-time weighted build over the
    # strided window (a D-deep multiply-add per offset)
    rank = counts["rank_cands"] * px * 4 * RANK_OPS_PER_ANCHOR
    build = counts["build_offs"] * px * (2 * d + WEIGHT_OPS_PER_OFFSET)
    return {
        "semantic_flops": exact + rank + build,
        "exact_flops": exact,
        "rank_flops": rank,
        "build_flops": build,
        "transcendentals": (counts["exps"] + counts["build_offs"]) * px,
        "evaluations": counts["launches"],
    }
