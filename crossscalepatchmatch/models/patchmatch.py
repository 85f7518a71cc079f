"""Data-parallel PatchMatch optimizer over slanted-plane fields.

Reference loop (cs_patchmatch.cc:51-109): random init, then 3 iterations of
{sequential raster spatial propagation, sequential scatter view propagation,
randomized plane refinement}, all funneling into per-pixel plane-cost
evaluations.

Restructured for a data-parallel accelerator (SURVEY.md section 7):
  * Spatial propagation (cs_patchmatch.cc:163-216) is a strictly sequential
    raster scan -- each pixel consumes the already-updated previous neighbor.
    Here it becomes dense synchronous sweeps: every pixel evaluates the planes
    of a static stencil of neighbors (4-adjacent plus Gipuma-style far
    candidates at the +-far_offsets ladder) from the previous sweep and
    adopts the argmin.
    Per dense evaluation this propagates information one stencil hop for every
    pixel at full utilization, which matches red-black checkerboarding's
    hops-per-evaluation on hardware that cannot skip the inactive half.
  * View propagation (cs_patchmatch.cc:229-277) is a sequential scatter into
    the other view; scatters race under parallel execution, so each pixel
    instead *gathers* the other view's plane at its warped correspondence and
    re-anchors it locally -- the same fixed points, race-free and dense.
  * Plane refinement (cs_patchmatch.cc:292-345) is already pixel-parallel:
    the halving perturbation schedule runs as a lax.scan.
  * cv::RNG seeded with time(NULL) per OpenMP row (cs_patchmatch.cc:130,309,
    a determinism bug -- all rows share one seed) is replaced by threefry key
    splits: deterministic, per-pixel independent streams.

Everything is a pure function of (volumes, state, key); the whole optimizer
jits into a single XLA program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Tuple

import jax
import jax.numpy as jnp

from ..backend import cost_backend
from ..config import CSPMConfig
from ..ops import plane
from ..ops.cost_volume import VolumeData
from ..ops.plane_cost import cross_scale_plane_cost, window_plane_cost
from ..ops.scale_weights import scale_weights

# cost_fn: f32[2, K, H, W, 3] candidate planes -> f32[2, K, H, W] costs
CostFn = Callable[[jax.Array], jax.Array]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PMState:
    """Optimizer state: per-view plane field and its current best cost."""

    abc: jax.Array    # f32[2, H, W, 3]
    cost: jax.Array   # f32[2, H, W]


def make_fly_cost_fn(cfg: CSPMConfig, l_bgr_u8: jax.Array,
                     r_bgr_u8: jax.Array) -> CostFn:
    """On-the-fly GrdPC/CSPC plane-cost evaluator (no volumes).

    Covers the reference's query-time IPlaneCost family
    (plane_cost/grd_pc.cc, plane_cost/cspc.cc).
    """
    from ..ops.color import bgr_to_lab_u8
    from ..ops.onthefly_cost import cs_fly_cost, grd_fly_cost, gray_gradient
    from ..ops.pyramid import build_pyramid

    levels = cfg.scale_num if cfg.use_cs else 1
    l_pyr = build_pyramid(l_bgr_u8, levels)
    r_pyr = build_pyramid(r_bgr_u8, levels)
    l_grd = [gray_gradient(im) for im in l_pyr]
    r_grd = [gray_gradient(im) for im in r_pyr]
    # USE_LAB_WGT capability (grd_pc.cc:31-35, cspc.cc:48-49): ASW weights
    # on the per-level Lab conversions; data term stays BGR/gradient
    l_wgt = ([bgr_to_lab_u8(im) for im in l_pyr]
             if cfg.use_lab_weights else None)
    r_wgt = ([bgr_to_lab_u8(im) for im in r_pyr]
             if cfg.use_lab_weights else None)
    kw = dict(half_wnd=cfg.half_wnd, max_dis=cfg.max_dis,
              gamma=cfg.wgt_gamma, alpha=cfg.cost_alpha,
              tau_clr=cfg.tau_clr, tau_grd=cfg.tau_grd)

    if cfg.use_cs:
        wgts = tuple(float(x) for x in
                     scale_weights(cfg.scale_num, cfg.reg_lambda))

        def cost_fn(abc2: jax.Array) -> jax.Array:
            cl = cs_fly_cost(l_pyr, r_pyr, l_grd, r_grd, wgts, abc2[0],
                             sign=-1, pyr_wgt_ref=l_wgt, **kw)
            cr = cs_fly_cost(r_pyr, l_pyr, r_grd, l_grd, wgts, abc2[1],
                             sign=+1, pyr_wgt_ref=r_wgt, **kw)
            return jnp.stack([cl, cr])
    else:
        def cost_fn(abc2: jax.Array) -> jax.Array:
            cl = grd_fly_cost(l_pyr[0], r_pyr[0], l_grd[0], r_grd[0],
                              abc2[0], sign=-1,
                              ref_wgt=None if l_wgt is None else l_wgt[0],
                              **kw)
            cr = grd_fly_cost(r_pyr[0], l_pyr[0], r_grd[0], l_grd[0],
                              abc2[1], sign=+1,
                              ref_wgt=None if r_wgt is None else r_wgt[0],
                              **kw)
            return jnp.stack([cl, cr])

    return cost_fn


def vol_dtype(cfg: CSPMConfig):
    """Storage dtype of the kernel-layout volumes (config.vol_dtype)."""
    return jnp.bfloat16 if cfg.vol_dtype == "bf16" else jnp.float32


def _volume_sparse_fn(cfg: CSPMConfig, vd: VolumeData) -> CostFn:
    """Quadrant-volume prescreen evaluator (cfg.prescreen_mode="volume").

    The quadrant volumes are built once per pair (plain jnp on every
    backend) and ranked per candidate batch.
    """
    from ..ops.prescreen_volume import (build_quadrant_volumes,
                                        quadrant_prescreen_cost)
    build = functools.partial(build_quadrant_volumes, half_wnd=cfg.half_wnd,
                              gamma=cfg.wgt_gamma,
                              stride=max(cfg.prescreen_stride, 1))
    bq, wq = jax.vmap(build)(vd.weight_imgs[0], vd.vols[0])
    max_costs = vd.max_costs[0]
    rank = functools.partial(quadrant_prescreen_cost,
                             half_wnd=cfg.half_wnd, max_dis=cfg.max_dis)

    def sparse_fn(abc2: jax.Array) -> jax.Array:
        return jax.vmap(rank)(bq, wq, max_costs, abc2)

    return sparse_fn


def _kernel_cost_fns(cfg: CSPMConfig, vd: VolumeData,
                     interpret: bool = False
                     ) -> Tuple[CostFn, CostFn | None]:
    """(exact, strided-window) evaluators on the fused window-cost kernel
    (ops.pallas.window_cost); the strided one is None for cross-scale.

    The kernel layout of every level's image and volume is built once
    here, per pair, not per evaluation.  interpret=True runs the Pallas
    interpreter (CPU tests).
    """
    from ..ops.pallas import window_cost as wc

    preps = [wc.prepare(img, vol, vol_dtype(cfg))
             for img, vol in zip(vd.weight_imgs, vd.vols)]
    kw = dict(half_wnd=cfg.half_wnd, max_dis=cfg.max_dis,
              gamma=cfg.wgt_gamma, interpret=interpret)
    if cfg.use_cs:
        wgts = tuple(float(x) for x in
                     scale_weights(cfg.scale_num, cfg.reg_lambda))

        def cost_fn(abc2: jax.Array) -> jax.Array:
            return wc.cross_scale_cost_prepared(preps, vd.max_costs, wgts,
                                                abc2, **kw)

        return cost_fn, None

    def kernel_fn(abc2: jax.Array, stride: int) -> jax.Array:
        return wc.window_cost_prepared(preps[0], vd.max_costs[0], abc2,
                                       wnd_stride=stride, **kw)

    return (functools.partial(kernel_fn, stride=1),
            functools.partial(kernel_fn, stride=cfg.prescreen_stride))


def _jnp_cost_fns(cfg: CSPMConfig,
                  vd: VolumeData) -> Tuple[CostFn, CostFn | None]:
    """(exact, strided-window) evaluators on the jnp authority
    (ops.plane_cost); the strided one is None for cross-scale."""
    if cfg.use_cs:
        wgts = tuple(float(x) for x in
                     scale_weights(cfg.scale_num, cfg.reg_lambda))

        def eval_view(imgs, vols, max_costs, abc):
            return cross_scale_plane_cost(
                imgs, vols, max_costs, wgts, abc, half_wnd=cfg.half_wnd,
                max_dis=cfg.max_dis, gamma=cfg.wgt_gamma)

        def cost_fn(abc2: jax.Array) -> jax.Array:
            return jax.vmap(eval_view)(vd.weight_imgs, vd.vols,
                                       vd.max_costs, abc2)

        return cost_fn, None
    img, vol, mc = vd.weight_imgs[0], vd.vols[0], vd.max_costs[0]

    def jnp_fn(abc2: jax.Array, stride: int) -> jax.Array:
        fn = functools.partial(window_plane_cost, half_wnd=cfg.half_wnd,
                               max_dis=cfg.max_dis, gamma=cfg.wgt_gamma,
                               wnd_stride=stride)
        return jax.vmap(fn)(img, vol, mc, abc2)

    return (functools.partial(jnp_fn, stride=1),
            functools.partial(jnp_fn, stride=cfg.prescreen_stride))


def make_cost_fns(cfg: CSPMConfig,
                  vd: VolumeData) -> Tuple[CostFn, CostFn | None]:
    """Bind the per-view volume data into batched plane-cost evaluators.

    Returns (cost_fn, sparse_fn): the exact evaluator, on the backend
    backend.cost_backend picks, plus the prescreen evaluator (None when
    prescreening is disabled, or for the strided-window prescreen of a
    cross-scale config).
    """
    # the window prescreen exists for single-scale only; the quadrant-
    # volume prescreen also serves cross-scale configs by ranking on the
    # FINE pyramid level (the dominant term of the scale-weighted sum --
    # a ranking heuristic like the prescreen itself, exact CS adoption
    # costs are unchanged)
    if cost_backend(cfg) == "pallas":
        cost_fn, strided_fn = _kernel_cost_fns(cfg, vd)
    else:
        cost_fn, strided_fn = _jnp_cost_fns(cfg, vd)
    if cfg.prescreen_stride <= 1 or not cfg.precompute_volume:
        return cost_fn, None
    if cfg.prescreen_mode == "volume":
        return cost_fn, _volume_sparse_fn(cfg, vd)
    return cost_fn, strided_fn


def make_cost_fn(cfg: CSPMConfig, vd: VolumeData) -> CostFn:
    """Exact batched plane-cost evaluator (see make_cost_fns)."""
    return make_cost_fns(cfg, vd)[0]


def make_sparse_cost_fn(cfg: CSPMConfig, vd: VolumeData) -> CostFn | None:
    """Strided-window prescreen evaluator alone (see make_cost_fns).

    Prefer make_cost_fns when both evaluators are needed -- it shares the
    kernel layout between them.
    """
    return make_cost_fns(cfg, vd)[1]


def _prescreen(cand_abc: jax.Array, sparse_fn: CostFn | None) -> jax.Array:
    """Narrow a K-candidate batch to its per-pixel sparse-cost winner."""
    if sparse_fn is None or cand_abc.shape[1] == 1:
        return cand_abc
    sc = sparse_fn(cand_abc)
    best_k = jnp.argmin(sc, axis=1)
    return jnp.take_along_axis(
        cand_abc, best_k[:, None, ..., None], axis=1)


def _adopt(state: PMState, cand_abc: jax.Array,
           cand_cost: jax.Array) -> PMState:
    """Adopt, per pixel, the best candidate iff it strictly improves.

    cand_abc: f32[2, K, H, W, 3]; cand_cost: f32[2, K, H, W].
    Strict `<` matches the reference's update predicate
    (cs_patchmatch.cc:201,209,270,335).
    """
    best_k = jnp.argmin(cand_cost, axis=1)                       # [2, H, W]
    best_cost = jnp.min(cand_cost, axis=1)
    best_abc = jnp.take_along_axis(
        cand_abc, best_k[:, None, ..., None], axis=1)[:, 0]
    improve = best_cost < state.cost
    return PMState(
        abc=jnp.where(improve[..., None], best_abc, state.abc),
        cost=jnp.where(improve, best_cost, state.cost))


def _stencil(cfg: CSPMConfig, sweep: int = 0) -> List[Tuple[int, int]]:
    """Candidate offsets for one sweep: the 4-adjacent ring plus one far
    ring.  With several far_offsets, consecutive sweeps cycle through the
    rings (sweep 0 -> offsets[0], sweep 1 -> offsets[1], ...), so a
    2-sweep iteration with (5, 25) reaches ~30 px per iteration at the
    same K=8 evaluation cost as a single-ring stencil."""
    offsets = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    if cfg.far_offsets:
        f = cfg.far_offsets[sweep % len(cfg.far_offsets)]
        offsets += [(0, f), (0, -f), (f, 0), (-f, 0)]
    return offsets


def spatial_sweep(state: PMState, cost_fn: CostFn, cfg: CSPMConfig,
                  sweep: int = 0,
                  sparse_fn: CostFn | None = None,
                  extra: jax.Array | None = None,
                  include_current: bool = False) -> PMState:
    """One dense propagation sweep: every pixel tests its stencil's planes.

    `extra` ([2, E, H, W, 3]) joins the candidate batch AFTER the
    prescreen narrowing (used by cfg.merge_view to ride the view-
    propagation candidate on the sweep's exact launch).

    `include_current` PREPENDS the current plane to the candidate batch:
    the deferred-cost trick (see patchmatch()) -- a state whose held cost
    is +inf (rank-unit, or never evaluated) gets its exact cost from the
    same launch that evaluates the sweep winner, saving the standalone
    K=1 refresh launch.  Prepended, not appended, so a cost tie keeps
    the current plane exactly like the reference's strict-improvement
    adoption (cs_patchmatch.cc:201,209).
    """
    cands = [jnp.roll(state.abc, (dy, dx), axis=(1, 2))
             for dy, dx in _stencil(cfg, sweep)]
    cand_abc = _prescreen(jnp.stack(cands, axis=1), sparse_fn)
    if include_current:
        cand_abc = jnp.concatenate([state.abc[:, None], cand_abc], axis=1)
    if extra is not None:
        cand_abc = jnp.concatenate([cand_abc, extra], axis=1)
    cand_cost = cost_fn(cand_abc)
    return _adopt(state, cand_abc, cand_cost)


def view_candidates(state: PMState, cfg: CSPMConfig) -> jax.Array:
    """Cross-view plane-transfer candidates as a gather.

    For each pixel x of view v: warp by the pixel's own current disparity to
    the corresponding column of the other view, read that pixel's plane,
    clamp its disparity to [0, max_dis-1] (cs_patchmatch.cc:250-255), and
    re-anchor the plane through (x, y, d) with the same orientation
    (cs_patchmatch.cc:265-267).  Out-of-range warps wrap by +-W
    (HandleBorder, commfunc.h:129-145).

    Returns f32[2, 1, H, W, 3].
    """
    _, h, w, _ = state.abc.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)

    def per_view(abc_v, abc_other, sign):
        d_own = jnp.clip(plane.disparity_at(abc_v, xs, ys),
                         0.0, cfg.max_dis - 1.0)
        xw = (xs.astype(jnp.int32)
              + sign * jnp.rint(d_own).astype(jnp.int32)) % w
        src = jnp.take_along_axis(abc_other, xw[..., None], axis=1)
        d_src = jnp.clip(
            plane.disparity_at(src, xw.astype(jnp.float32), ys),
            0.0, cfg.max_dis - 1.0)
        return plane.reanchor(src, xs, ys, d_src)

    # Left pixels correspond to right columns x - d; right to left x + d.
    cand_l = per_view(state.abc[0], state.abc[1], -1)
    cand_r = per_view(state.abc[1], state.abc[0], +1)
    return jnp.stack([cand_l, cand_r])[:, None]       # [2, 1, H, W, 3]


def view_propagation(state: PMState, cost_fn: CostFn,
                     cfg: CSPMConfig) -> PMState:
    """Standalone view-propagation step (see view_candidates)."""
    cand_abc = view_candidates(state, cfg)
    cand_cost = cost_fn(cand_abc)
    return _adopt(state, cand_abc, cand_cost)


def plane_refinement(state: PMState, key: jax.Array, cost_fn: CostFn,
                     cfg: CSPMConfig,
                     sparse_fn: CostFn | None = None) -> PMState:
    """Randomized refinement with the halving perturbation schedule.

    Two modes:
      * sequential (`batch_refine=False`): the reference's loop
        (cs_patchmatch.cc:292-345) -- each halving round perturbs the
        *currently adopted* plane and adopts immediately.
      * batched (`batch_refine=True`, the default): all R rounds'
        perturbations are proposed from the plane held at entry and
        evaluated as one K=R candidate batch, adopting the argmin.  Same
        multi-resolution search, one evaluation instead of R sequential
        ones; the minor trajectory difference is covered by the
        end-to-end accuracy tests.
    """
    zs = jnp.asarray(cfg.refinement_schedule(), jnp.float32)
    ns = cfg.max_norm * zs / zs[0]    # n halves in lockstep with z

    if cfg.batch_refine:
        r = len(cfg.refinement_schedule())
        keys = jax.random.split(key, 2 * r).reshape(2, r, -1)
        stages = max(1, min(cfg.refine_stages, r))
        per = -(-r // stages)
        for s0 in range(0, r, per):
            rounds = range(s0, min(s0 + per, r))
            cands = [jnp.stack([
                plane.perturb_planes(keys[v, i], state.abc[v], zs[i],
                                     ns[i], cfg.eps) for i in rounds])
                for v in range(2)]
            cand_abc = _prescreen(jnp.stack(cands), sparse_fn)
            state = _adopt(state, cand_abc, cost_fn(cand_abc))
        return state

    def body(carry, zn):
        st, k = carry
        z, n = zn
        k, k0, k1 = jax.random.split(k, 3)
        prop_l = plane.perturb_planes(k0, st.abc[0], z, n, cfg.eps)
        prop_r = plane.perturb_planes(k1, st.abc[1], z, n, cfg.eps)
        cand_abc = jnp.stack([prop_l, prop_r])[:, None]
        cand_cost = cost_fn(cand_abc)
        return (_adopt(st, cand_abc, cand_cost), k), None

    (state, _), _ = jax.lax.scan(body, (state, key), (zs, ns))
    return state


def init_state(key: jax.Array, hw: Tuple[int, int],
               cost_fn: CostFn | None, cfg: CSPMConfig) -> PMState:
    """Random plane init + initial cost (cs_patchmatch.cc:115-148).

    cost_fn=None defers the initial evaluation: the held cost is +inf and
    the first sweep's include_current launch establishes it (deferred-cost
    entry, see patchmatch()).
    """
    h, w = hw
    abc = plane.random_planes(key, (2, h, w), float(cfg.max_dis), cfg.eps)
    if cost_fn is None:
        return PMState(abc=abc, cost=jnp.full((2,) + hw, jnp.inf,
                                              jnp.float32))
    cost = cost_fn(abc[:, None])[:, 0]
    return PMState(abc=abc, cost=cost)


def iteration_step(state: PMState, key: jax.Array, cost_fn: CostFn,
                   cfg: CSPMConfig,
                   sparse_fn: CostFn | None = None,
                   include_current: bool = False) -> PMState:
    """One outer PatchMatch iteration: propagation sweeps, view
    propagation, refinement (the loop body of cs_patchmatch.cc:61-99).

    With cfg.merge_view the view-propagation candidate joins the last
    sweep's candidate batch (one launch fewer; see config.merge_view).
    `include_current` is forwarded to the FIRST sweep (deferred-cost
    entry, see patchmatch()).
    """
    for i in range(cfg.prop_sweeps):
        merge = cfg.merge_view and i == cfg.prop_sweeps - 1
        state = spatial_sweep(
            state, cost_fn, cfg, sweep=i, sparse_fn=sparse_fn,
            extra=view_candidates(state, cfg) if merge else None,
            include_current=include_current and i == 0)
    if not (cfg.merge_view and cfg.prop_sweeps > 0):
        state = view_propagation(state, cost_fn, cfg)
    state = plane_refinement(state, key, cost_fn, cfg, sparse_fn=sparse_fn)
    return state


def iteration_keys(key: jax.Array, cfg: CSPMConfig) -> jax.Array:
    """Per-iteration RNG keys (split once so checkpoint resume at iteration
    i reproduces the uninterrupted run exactly)."""
    _, k_loop = jax.random.split(key)
    return jax.random.split(k_loop, cfg.max_iter)


def patchmatch(key: jax.Array, hw: Tuple[int, int], cost_fn: CostFn,
               cfg: CSPMConfig,
               sparse_fn: CostFn | None = None) -> PMState:
    """Full optimizer: init + max_iter outer iterations.

    cfg.adopt_mode schedules which evaluator decides adoptions:
      * "exact": every decision on cost_fn (reference-faithful).
      * "rank": every decision on the quadrant ranking costs (sparse_fn
        as the adoption metric; no exact evaluations at all).
      * "rank+exact": rank mode for the first max_iter - exact_iters
        iterations, then exact_iters exact final iterations.

    Deferred-cost entry into the exact phase (prop_sweeps > 0): instead
    of a standalone K=1 exact evaluation of the held planes (the init
    eval in "exact" mode / the rank->exact cost refresh), the held cost
    is set to +inf and the first exact sweep evaluates the current plane
    as a PREPENDED candidate in the same launch as the sweep winner --
    argmin over {current, winner} with current first equals strict-
    improvement adoption against a refreshed cost, so the trajectory is
    identical while one fixed-launch-cost K=1 evaluation disappears.
    """
    k_init, _ = jax.random.split(key)
    keys = iteration_keys(key, cfg)
    n_rank = cfg.rank_iters if sparse_fn is not None else 0
    n_exact = cfg.max_iter - n_rank
    defer = cfg.prop_sweeps > 0 and n_exact > 0

    init_fn = sparse_fn if n_rank else (None if defer else cost_fn)
    state = init_state(k_init, hw, init_fn, cfg)
    if n_rank:
        # adoption compares sparse_fn units against state.cost built from
        # sparse_fn -- consistent; no prescreen-within-rank (it IS the
        # metric)
        state, _ = jax.lax.scan(
            lambda st, k: (iteration_step(st, k, sparse_fn, cfg, None),
                           None),
            state, keys[:n_rank])
    if n_rank and n_exact:
        # switch metrics: the held rank-unit cost is not comparable to
        # exact costs; invalidate it (defer) or refresh it exactly
        state = PMState(
            abc=state.abc,
            cost=(jnp.full_like(state.cost, jnp.inf) if defer
                  else cost_fn(state.abc[:, None])[:, 0]))
    if n_exact:
        k0 = n_rank
        if defer:
            state = iteration_step(state, keys[k0], cost_fn, cfg,
                                   sparse_fn, include_current=True)
            k0 += 1
        if cfg.max_iter > k0:
            state, _ = jax.lax.scan(
                lambda st, k: (iteration_step(st, k, cost_fn, cfg,
                                              sparse_fn), None),
                state, keys[k0:])
    return state


def plane_to_disp(abc: jax.Array, dis_scale: int) -> jax.Array:
    """u8 disparity maps: saturate(round(d * dis_scale))
    (cs_patchmatch.cc:590-602; round-half-to-even like Round2Int)."""
    _, h, w, _ = abc.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    d = plane.disparity_at(abc, xs, ys)
    return jnp.clip(jnp.rint(d * dis_scale), 0, 255).astype(jnp.uint8)
