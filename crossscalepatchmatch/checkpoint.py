"""Iteration-level checkpoint / resume of the PatchMatch optimizer state.

The reference never serializes state (runs are seconds-to-minutes,
SURVEY.md section 5); for long batched/high-resolution device jobs the
(plane, min_cost) state is checkpointed after every outer iteration and a
killed job resumes bit-exactly: per-iteration RNG keys are derived from the
run seed once (models.patchmatch.iteration_keys), so iterations i..N replay
identically whether or not the process restarted.

Format: a single .npz per checkpoint (atomic rename), orbax-free so the
file is portable and inspectable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import CSPMConfig
from .models import patchmatch as pm
from .models.pipeline import run_pair  # noqa: F401  (public surface)
from .models.postprocess import postprocess
from .ops.cost_volume import build_volume_data


def save_state(path: str, state: pm.PMState, iteration: int,
               cfg: CSPMConfig, seed: int) -> None:
    """Atomically write (state, iteration, config fingerprint)."""
    tmp_fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".npz")
    os.close(tmp_fd)
    cfg_json = json.dumps(dataclasses.asdict(cfg), default=str,
                          sort_keys=True)
    np.savez(tmp, abc=np.asarray(state.abc), cost=np.asarray(state.cost),
             iteration=np.int64(iteration), seed=np.int64(seed),
             cfg=np.bytes_(cfg_json.encode()))
    os.replace(tmp, path)


def load_state(path: str, cfg: CSPMConfig,
               seed: int) -> Optional[Tuple[pm.PMState, int]]:
    """Load a checkpoint; None if absent or from a different run config."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        cfg_json = json.dumps(dataclasses.asdict(cfg), default=str,
                              sort_keys=True)
        if z["cfg"].item().decode() != cfg_json or int(z["seed"]) != seed:
            return None
        state = pm.PMState(abc=jnp.asarray(z["abc"]),
                           cost=jnp.asarray(z["cost"]))
        return state, int(z["iteration"])


def _shards_to_disk(path: str, arrs, iteration: int, cfg: CSPMConfig,
                    seed_fp: int) -> None:
    """Save the process-addressable shards of global arrays (one file per
    process: multi-host safe, no cross-host gathering)."""
    payload = {"iteration": np.int64(iteration), "seed": np.int64(seed_fp),
               "cfg": np.bytes_(json.dumps(
                   dataclasses.asdict(cfg), default=str,
                   sort_keys=True).encode())}
    for name, a in arrs.items():
        for i, sh in enumerate(a.addressable_shards):
            payload[f"{name}/{i}/data"] = np.asarray(sh.data)
            payload[f"{name}/{i}/idx"] = np.array(
                [s.indices(dim) for s, dim in zip(sh.index, a.shape)],
                np.int64)
        payload[f"{name}/shape"] = np.array(a.shape, np.int64)
    tmp_fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   suffix=".npz")
    os.close(tmp_fd)
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _shards_from_disk(path: str, names, mesh, specs, cfg: CSPMConfig,
                      seed_fp: int):
    """Rebuild global sharded arrays from this process's shard file; None
    if absent or from a different run."""
    from jax.sharding import NamedSharding

    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        cfg_json = json.dumps(dataclasses.asdict(cfg), default=str,
                              sort_keys=True)
        if (z["cfg"].item().decode() != cfg_json
                or int(z["seed"]) != seed_fp):
            return None
        out = []
        for name, spec in zip(names, specs):
            shape = tuple(int(v) for v in z[f"{name}/shape"])
            by_index = {}
            i = 0
            while f"{name}/{i}/data" in z:
                key = tuple(tuple(int(v) for v in t)
                            for t in z[f"{name}/{i}/idx"])
                by_index[key] = z[f"{name}/{i}/data"]
                i += 1
            sharding = NamedSharding(mesh, spec)

            def cb(idx, d=by_index, shp=shape):
                key = tuple(sl.indices(dim) for sl, dim in zip(idx, shp))
                return jnp.asarray(d[key])

            out.append(jax.make_array_from_callback(shape, sharding, cb))
        return tuple(out), int(z["iteration"])


def run_batch_sharded_resumable(l_bgr, r_bgr, seeds, cfg: CSPMConfig, mesh,
                                ckpt_path: str):
    """Sharded batch pipeline with per-iteration checkpointing of the
    process-local PMState shards and bit-exact resume.

    Each process writes `{ckpt_path}.proc{k}` holding only its addressable
    (abc, cost) shards -- no cross-host gathering; a restarted job with the
    same mesh layout reloads its own file.  Iteration keys are pre-split
    from the per-pair seeds (parallel.tiled.run_batch_sharded_steps), so
    the resumed run equals the uninterrupted one bit-for-bit.

    Returns u8[B, 2, H, W] like run_batch_sharded.
    """
    from jax.sharding import PartitionSpec as P

    from .parallel.tiled import run_batch_sharded_steps

    tx_ax = "tx" if "tx" in dict(mesh.shape) else None
    specs = (P("data", None, "ty", tx_ax, None),
             P("data", None, "ty", tx_ax))
    path = f"{ckpt_path}.proc{jax.process_index()}"
    seed_fp = int(np.asarray(seeds)[0])

    resumed = _shards_from_disk(path, ("abc", "cost"), mesh, specs, cfg,
                                seed_fp)
    if resumed is None:
        state = run_batch_sharded_steps(l_bgr, r_bgr, seeds, cfg, mesh,
                                        state=None, it_lo=0, it_hi=0)
        start = 0
        jax.block_until_ready(state)
        _shards_to_disk(path, {"abc": state[0], "cost": state[1]}, 0, cfg,
                        seed_fp)
    else:
        state, start = resumed

    for it in range(start, cfg.max_iter):
        state = run_batch_sharded_steps(l_bgr, r_bgr, seeds, cfg, mesh,
                                        state=state, it_lo=it, it_hi=it + 1)
        jax.block_until_ready(state)
        _shards_to_disk(path, {"abc": state[0], "cost": state[1]}, it + 1,
                        cfg, seed_fp)

    return run_batch_sharded_steps(l_bgr, r_bgr, seeds, cfg, mesh,
                                   state=state, it_lo=cfg.max_iter,
                                   finalize=True)


def run_pair_resumable(l_bgr_u8, r_bgr_u8, cfg: CSPMConfig, ckpt_path: str,
                       seed: int = 0):
    """run_pair with per-iteration checkpointing and bit-exact resume.

    Returns the same dict as models.pipeline.run_pair (NumPy arrays).
    """
    l = jnp.asarray(l_bgr_u8)
    r = jnp.asarray(r_bgr_u8)
    h, w, _ = l.shape

    import functools

    # The cost volumes are a pure function of the (unchanging) images, so
    # they are built ONCE here and threaded through every step as a pytree
    # instead of being rebuilt inside each per-iteration jit call.
    _build = jax.jit(build_volume_data, static_argnames=("cfg",))

    # Rank-adoption scheduling (models.patchmatch.patchmatch): iterations
    # [0, n_rank) adopt on the quadrant ranking costs, the rest on exact
    # costs.  Crossing the boundary uses the same deferred-cost entry as
    # patchmatch(): the held rank-unit cost is invalidated to +inf and
    # iteration n_rank's first sweep evaluates the current plane as a
    # prepended candidate (include_current).  A checkpoint saved inside
    # the rank phase holds rank-unit costs; the invalidation replays at
    # loop index n_rank whether or not the process restarted, so resume
    # stays bit-exact.
    n_rank = cfg.rank_iters
    defer = cfg.prop_sweeps > 0 and cfg.max_iter > n_rank

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def _init(vd, seed, cfg):
        cost_fn, sparse_fn = pm.make_cost_fns(cfg, vd)
        key = jax.random.PRNGKey(seed)
        k_init, _ = jax.random.split(key)
        init_fn = sparse_fn if n_rank else (None if defer else cost_fn)
        return pm.init_state(k_init, (h, w), init_fn, cfg)

    @functools.partial(jax.jit,
                       static_argnames=("cfg", "rank", "include_current"))
    def _step(vd, seed, state, iteration, cfg, rank,
              include_current=False):
        cost_fn, sparse_fn = pm.make_cost_fns(cfg, vd)
        cf, sf = (sparse_fn, None) if rank else (cost_fn, sparse_fn)
        keys = pm.iteration_keys(jax.random.PRNGKey(seed), cfg)
        return pm.iteration_step(state, keys[iteration], cf, cfg, sf,
                                 include_current=include_current)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def _refresh(vd, state, cfg):
        cost_fn, _ = pm.make_cost_fns(cfg, vd)
        return pm.PMState(abc=state.abc,
                          cost=cost_fn(state.abc[:, None])[:, 0])

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def _finalize(vd, state, cfg):
        dis = pm.plane_to_disp(state.abc, cfg.dis_scale)
        if cfg.use_pp:
            dis, valid = postprocess(dis, state.abc, vd.imgs[0], cfg)
        else:
            valid = jnp.ones((2, h, w), bool)
        return {"dis": dis, "abc": state.abc, "cost": state.cost,
                "valid": valid}

    vd = _build(l, r, cfg=cfg)
    resumed = load_state(ckpt_path, cfg, seed)
    if resumed is None:
        state, start = _init(vd, jnp.int32(seed), cfg), 0
        save_state(ckpt_path, state, 0, cfg, seed)
    else:
        state, start = resumed

    for it in range(start, cfg.max_iter):
        inc = False
        if n_rank and it == n_rank:
            # crossing rank->exact: invalidate (defer) or refresh the
            # held cost in exact units
            if defer:
                state = pm.PMState(
                    abc=state.abc,
                    cost=jnp.full_like(state.cost, jnp.inf))
                inc = True
            else:
                state = _refresh(vd, state, cfg)
        elif defer and not n_rank and it == 0:
            inc = True     # deferred init eval ("exact" mode)
        state = _step(vd, jnp.int32(seed), state, jnp.int32(it), cfg,
                      rank=it < n_rank, include_current=inc)
        jax.block_until_ready(state.abc)
        save_state(ckpt_path, state, it + 1, cfg, seed)

    out = _finalize(vd, state, cfg)
    return {k: np.asarray(v) for k, v in out.items()}
