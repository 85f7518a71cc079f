"""End-to-end stereo pipeline: images -> uint8 disparity maps.

The equivalent of the reference driver main() (CSPM/main.cc:57-139):
build cost volumes (PreSSPC / PreCSPC construction), run the PatchMatch
optimizer, convert planes to scaled uint8 disparity, optionally post-process.
The whole pipeline is one jittable function of the image pair with the config
static, so XLA sees (and fuses) everything.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp

from ..config import CSPMConfig
from ..ops.cost_volume import build_volume_data
from . import patchmatch as pm
from .postprocess import postprocess


def _make_cost_fn(l_bgr_u8, r_bgr_u8, cfg: CSPMConfig):
    """Bind the configured plane-cost backend.

    Returns (cost_fn, sparse_fn_or_None, pp_imgs)."""
    if cfg.precompute_volume:
        vd = build_volume_data(l_bgr_u8, r_bgr_u8, cfg)
        cost_fn, sparse_fn = pm.make_cost_fns(cfg, vd)
        return (cost_fn, sparse_fn, vd.imgs[0])
    return (pm.make_fly_cost_fn(cfg, l_bgr_u8, r_bgr_u8), None,
            jnp.stack([l_bgr_u8, r_bgr_u8]))


def _finalize(state: pm.PMState, pp_imgs, cfg: CSPMConfig
              ) -> Dict[str, jax.Array]:
    """Planes -> scaled u8 disparity (+ optional post-processing)."""
    _, h, w = state.cost.shape
    dis = pm.plane_to_disp(state.abc, cfg.dis_scale)
    if cfg.use_pp:
        dis, valid = postprocess(dis, state.abc, pp_imgs, cfg)
    else:
        valid = jnp.ones((2, h, w), bool)
    return {"dis": dis, "abc": state.abc, "cost": state.cost, "valid": valid}


def _run_pair_impl(l_bgr_u8: jax.Array, r_bgr_u8: jax.Array, seed: jax.Array,
                   cfg: CSPMConfig) -> Dict[str, jax.Array]:
    h, w, _ = l_bgr_u8.shape
    cost_fn, sparse_fn, pp_imgs = _make_cost_fn(l_bgr_u8, r_bgr_u8, cfg)
    key = jax.random.PRNGKey(seed)
    state = pm.patchmatch(key, (h, w), cost_fn, cfg, sparse_fn)
    return _finalize(state, pp_imgs, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def run_pair(l_bgr_u8: jax.Array, r_bgr_u8: jax.Array, seed: jax.Array,
             cfg: CSPMConfig) -> Dict[str, jax.Array]:
    """Compute left/right disparity for one rectified pair.

    Args:
      l_bgr_u8 / r_bgr_u8: u8[H, W, 3] views.
      seed: i32 scalar RNG seed (traced; re-running with a new seed does not
        recompile).
      cfg: static engine configuration.

    Returns:
      dict with "dis" u8[2, H, W] scaled disparity maps, "abc" f32[2, H, W, 3]
      final plane fields, "cost" f32[2, H, W] final costs, and "valid"
      bool[2, H, W] LR-check mask (all-true when use_pp=False).
    """
    return _run_pair_impl(l_bgr_u8, r_bgr_u8, seed, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def run_pairs(l_bgr_u8: jax.Array, r_bgr_u8: jax.Array, seeds: jax.Array,
              cfg: CSPMConfig) -> Dict[str, jax.Array]:
    """Batched single-chip serving: B pairs through ONE compiled program.

    Pairs execute sequentially on-device (lax.map), so per-pair device
    time equals run_pair's; whether a vmapped batch would fill the card
    better is not measured yet.  What the batch mode buys: one host
    dispatch for B pairs, plus one compile and one output
    materialization for a whole job.

    The reference has no batch mode (main.cc processes one pair per
    process); the input.txt regression matrix (input.txt:1-20) is its
    natural workload: 12 pairs = one call.  For multi-chip batch data
    parallelism see parallel.tiled.run_batch_sharded; this is the
    one-chip serving path.

    Args:
      l_bgr_u8 / r_bgr_u8: u8[B, H, W, 3] stacked views.
      seeds: i32[B] per-pair RNG seeds.

    Returns: run_pair's dict with a leading batch axis on every entry.
    """
    return jax.lax.map(
        lambda args: _run_pair_impl(args[0], args[1], args[2], cfg),
        (l_bgr_u8, r_bgr_u8, seeds))


def run_pair_np(l_bgr_u8, r_bgr_u8, cfg: CSPMConfig, seed: int = 0):
    """Convenience wrapper taking/returning NumPy arrays."""
    import numpy as np

    out = run_pair(jnp.asarray(l_bgr_u8), jnp.asarray(r_bgr_u8),
                   jnp.int32(seed), cfg)
    return {k: np.asarray(v) for k, v in out.items()}


@functools.partial(jax.jit, static_argnames=("cfg", "warm_iters"))
def run_pair_warm(l_bgr_u8: jax.Array, r_bgr_u8: jax.Array, seed: jax.Array,
                  init_abc: jax.Array, cfg: CSPMConfig,
                  warm_iters: int = 1) -> Dict[str, jax.Array]:
    """run_pair initialized from a prior solution's plane field.

    The serving mode for video / sequence stereo (no reference
    counterpart -- the reference restarts from random planes every frame,
    cs_patchmatch.cc:115-148): the previous frame's converged plane field
    seeds the optimizer, whose costs are re-evaluated against the NEW
    frame's volumes, and only `warm_iters` outer iterations run instead of
    cfg.max_iter.

    Args:
      init_abc: f32[2, H, W, 3] plane field, e.g. run_pair's "abc" output
        for the previous frame.

    Returns: same dict as run_pair.
    """
    cost_fn, sparse_fn, pp_imgs = _make_cost_fn(l_bgr_u8, r_bgr_u8, cfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), warm_iters)
    defer = cfg.prop_sweeps > 0 and warm_iters > 0
    if defer:
        # deferred-cost entry (models.patchmatch.patchmatch): the seed
        # field's exact cost against the NEW frame rides the first
        # sweep's launch instead of a standalone K=1 evaluation
        state = pm.PMState(abc=init_abc,
                           cost=jnp.full(init_abc.shape[:-1], jnp.inf,
                                         jnp.float32))
        state = pm.iteration_step(state, keys[0], cost_fn, cfg, sparse_fn,
                                  include_current=True)
        keys = keys[1:]
    else:
        state = pm.PMState(abc=init_abc,
                           cost=cost_fn(init_abc[:, None])[:, 0])
    if warm_iters - int(defer) > 0:
        state, _ = jax.lax.scan(
            lambda st, k: (pm.iteration_step(st, k, cost_fn, cfg,
                                             sparse_fn), None),
            state, keys)
    return _finalize(state, pp_imgs, cfg)


def run_sequence_np(frames, cfg: CSPMConfig, seed: int = 0,
                    warm_iters: int = 1):
    """Sequence stereo: cold-start the first pair, warm-start the rest.

    Args:
      frames: iterable of (left u8[H,W,3], right u8[H,W,3]) pairs.

    Yields one run_pair-style NumPy dict per frame.
    """
    import numpy as np

    abc = None
    for i, (l, r) in enumerate(frames):
        if abc is None:
            out = run_pair(jnp.asarray(l), jnp.asarray(r),
                           jnp.int32(seed), cfg)
        else:
            out = run_pair_warm(jnp.asarray(l), jnp.asarray(r),
                                jnp.int32(seed + i), abc, cfg,
                                warm_iters=warm_iters)
        abc = out["abc"]
        yield {k: np.asarray(v) for k, v in out.items()}
