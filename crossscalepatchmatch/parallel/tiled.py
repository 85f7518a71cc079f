"""Spatially-tiled + data-parallel PatchMatch over a (data, ty, tx) mesh.

Sharding layout (SURVEY.md sections 2.3/5):
  * "data" shards independent stereo pairs (batch data parallelism);
  * "ty" shards the image rows of each pair into horizontal bands and
    "tx" the columns into blocks (2-D spatial tiling -- the stereo
    analogue of sequence parallelism), with halo exchange between mesh
    neighbors via lax.ppermute (multi-hop for halos taller than a block):
      - image + cost-volume halos: half_wnd (17 for wnd=35) pixels,
        exchanged once after the volume build;
      - plane-state halos: max(far_offsets) pixels, exchanged before
        every propagation sweep (rows and columns separately -- the
        stencil is axis-aligned, so corners are never needed);
      - disparity/validity/image halos for the weighted-median, once.
  * Both views of a pair live on the same shard.  Row-wide x-gathers
    (view propagation's warp, the LR check, scanline fill) stay on-shard
    on a row-band mesh; with "tx" sharding they run on tx-all-gathered
    full-width rows (u8 maps / plane rows -- tiny) and slice the local
    block back out.

Coordinate convention: each shard stores planes in *block-local* (x, y)
coordinates (d = a*x_local + b*y_local + c).  When a plane crosses a
shard boundary during halo exchange or a full-width gather, its c is
re-anchored (c +- b*j*Hs rows, c +- a*j*Ws columns) so the same
(a, b, c) convention holds everywhere.

Row-local pieces (GRD cost volume build: color diffs + x-Sobel; view
propagation; refinement; LR check; scanline fill) run unchanged on each
band.  The census volume build needs global row context (9x9 wrap
borders) and the cross-scale path needs whole-image pyramids: for those
the views (~0.5 MB/pair) are all-gathered along "ty" once and the coarse
per-scale volumes are built replicated on every shard -- the coarse
levels cost a geometrically decaying fraction of the fine level, so
sharding them would buy nothing.  On a GPU every scale evaluates through
the fused window-cost kernel with band-local validity bounds.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..backend import cost_backend
from ..config import CostMethod, CSPMConfig
from ..models import patchmatch as pm
from ..models import postprocess as pp
from ..ops import plane
from ..ops.cost_volume import build_volume
from ..ops.color import bgr_to_rgb
from ..ops.plane_cost import window_plane_cost


def extend_axis(x: jax.Array, halo: int, axis: int,
                axis_name: str) -> jax.Array:
    """Prepend/append `halo` slices along `axis` from the mesh neighbors
    on `axis_name`.

    Halos taller than one block are served by multi-hop exchange: the piece
    of the block at distance j moves in a single distance-j ppermute, so a
    halo of ceil(halo/n) blocks costs that many ppermutes, and far
    propagation rings / window halos are never silently truncated by small
    blocks.

    Devices at the mesh edge receive zeros for slices past the global image
    (lax.ppermute semantics), which callers mask via a validity vector.
    """
    n = jax.lax.axis_size(axis_name)
    size = x.shape[axis]
    hops = -(-halo // size)                        # blocks touched per side
    rem = halo - (hops - 1) * size                 # slices from the far one
    lo, hi = [], []
    for j in range(hops, 0, -1):                   # farthest block first
        take = rem if j == hops else size
        fwd = [(i, i + j) for i in range(n - j)]   # my slices -> j-th next
        bwd = [(i + j, i) for i in range(n - j)]   # my slices -> j-th prev
        tail = jax.lax.slice_in_dim(x, size - take, size, axis=axis)
        head = jax.lax.slice_in_dim(x, 0, take, axis=axis)
        lo.append(jax.lax.ppermute(tail, axis_name, fwd))
        hi.append(jax.lax.ppermute(head, axis_name, bwd))
    return jnp.concatenate(lo + [x] + hi[::-1], axis=axis)


def extend_rows(x: jax.Array, halo: int, axis_name: str = "ty") -> jax.Array:
    """extend_axis over the leading (row) axis."""
    return extend_axis(x, halo, 0, axis_name)


def extend_cols(x: jax.Array, halo: int, axis_name: str = "tx") -> jax.Array:
    """extend_axis over the second (column) axis."""
    return extend_axis(x, halo, 1, axis_name)


def _extend_planes(abc: jax.Array, halo: int, hs: int) -> jax.Array:
    """Halo-exchange plane state over rows, re-anchoring c into local
    coordinates.

    A plane received from the shard j bands above was expressed with row
    index y + j*Hs, so c_local = c_remote + b*j*Hs; from below,
    c_local = c - b*j*Hs.  j varies per extended row when the halo spans
    multiple bands (multi-hop exchange).
    """
    ext = extend_rows(abc, halo)
    top, mid, bot = ext[:halo], ext[halo:halo + hs], ext[halo + hs:]
    e = jnp.arange(halo)
    j_top = ((halo - e + hs - 1) // hs).astype(abc.dtype)  # source distance
    j_bot = (e // hs + 1).astype(abc.dtype)
    top = top.at[..., 2].add(top[..., 1] * (j_top * hs)[:, None])
    bot = bot.at[..., 2].add(-bot[..., 1] * (j_bot * hs)[:, None])
    return jnp.concatenate([top, mid, bot], axis=0)


def _extend_planes_cols(abc: jax.Array, halo: int, ws: int) -> jax.Array:
    """Column analogue of _extend_planes: a plane from the shard j blocks
    left carried x + j*Ws, so c_local = c_remote + a*j*Ws (minus from the
    right)."""
    ext = extend_cols(abc, halo)
    left = ext[:, :halo]
    mid = ext[:, halo:halo + ws]
    right = ext[:, halo + ws:]
    e = jnp.arange(halo)
    j_l = ((halo - e + ws - 1) // ws).astype(abc.dtype)
    j_r = (e // ws + 1).astype(abc.dtype)
    left = left.at[..., 2].add(left[..., 0] * (j_l * ws)[None, :])
    right = right.at[..., 2].add(-right[..., 0] * (j_r * ws)[None, :])
    return jnp.concatenate([left, mid, right], axis=1)


def _ext_from_full(full: jax.Array, start: jax.Array, size: int,
                   halo: int, axis: int = 0) -> jax.Array:
    """Slices [start - halo, start + size + halo) of a replicated
    full-extent array along `axis`, zero-filled outside the global image
    (the gather analogue of extend_axis for data every shard holds in
    full)."""
    pads = [(0, 0)] * full.ndim
    pads[axis] = (halo, halo)
    pad = jnp.pad(full, pads)
    return jax.lax.dynamic_slice_in_dim(pad, start, size + 2 * halo,
                                        axis=axis)


def _band_ext_from_full(full: jax.Array, row0: jax.Array, hs: int,
                        halo: int) -> jax.Array:
    """_ext_from_full over rows (kept for callers/tests)."""
    return _ext_from_full(full, row0, hs, halo, axis=0)


def _pair_sharded(l_loc: jax.Array, r_loc: jax.Array, seed: jax.Array,
                  cfg: CSPMConfig, n_ty: int, n_tx: int = 1,
                  has_tx: bool = True, state_in=None, it_lo: int = 0,
                  it_hi: int | None = None, finalize: bool = True):
    """Full pipeline for one pair's local block [Hs, Ws, 3] per view on a
    (ty, tx) spatial tile of the mesh.

    Data placement: the fine-scale GRD volume is built from row-band
    full-width views (an all_gather along "tx" -- the build needs up to
    max_dis columns of cross-view context, and the views are tiny); the
    census volume needs global row context (9x9 wrap borders,
    cen_cc.cc:30-43) and the cross-scale path needs whole-image pyramids,
    so for those the views are all-gathered along both spatial axes once
    and the coarse per-scale volumes are built replicated on every shard --
    coarse levels cost a geometrically decaying fraction of the fine level
    and sharding them would buy nothing (SURVEY.md section 7.8).

    Coordinates: planes are stored in block-local (x, y); halo exchange
    and the full-width gathers re-anchor c across shard boundaries
    (_extend_planes / _extend_planes_cols and the +- a*col0 shifts below).
    Row-wide stages (view propagation's x-warp gather, the LR check and
    scanline fill) run on tx-all-gathered full-width rows and slice the
    local columns back out.
    """
    hs, ws, _ = l_loc.shape
    hw = cfg.half_wnd
    # Far rings taller than the block are served by multi-hop halo exchange
    # (extend_axis), so the sweep stencil -- and therefore propagation
    # reach -- is identical to the single-device schedule on any block size.
    far = max(max(cfg.far_offsets, default=0), 1)

    ty = jax.lax.axis_index("ty")
    # axis_index even on a size-1 "tx" axis: the key (and so the whole
    # optimizer state) then carries the tx varying-axis tag, which keeps
    # the scan-carry vma stable once image-derived costs (sharded over tx
    # by the mesh) enter the state
    tx = jax.lax.axis_index("tx") if has_tx else 0
    row0 = ty * hs
    col0 = tx * ws
    h_glob = n_ty * hs
    w_glob = n_tx * ws
    key = jax.random.fold_in(jax.random.PRNGKey(seed), ty * n_tx + tx)
    levels = cfg.scale_num if cfg.use_cs else 1
    from ..config import Aggregator
    from ..ops.cost_volume import aggregate_volume
    aggregated = cfg.aggregator != Aggregator.NONE
    # aggregation filters span rows, so they also need the full views
    need_full = (cfg.use_cs or cfg.cost_method != CostMethod.GRD
                 or aggregated)
    spatial_axes = ("ty", "tx") if n_tx > 1 else ("ty",)

    imgs = jnp.stack([l_loc, r_loc])
    if n_tx > 1:
        # full-width row bands [2, Hs, W, 3] (view-prop / LR / fill need
        # whole rows; the GRD volume build needs max_dis columns of
        # context)
        imgs_roww = jax.lax.all_gather(imgs, "tx", axis=2, tiled=True)
    else:
        imgs_roww = imgs
    if need_full:
        full_imgs = jax.lax.all_gather(imgs_roww, "ty", axis=1, tiled=True)

    def _col_block(x, halo):
        """Local columns [col0 - halo, col0 + ws + halo) of a full-width
        per-view array [2, R, W, ...]."""
        if n_tx == 1:
            return x
        return jax.vmap(
            lambda v: _ext_from_full(v, col0, ws, halo, axis=1))(x)

    # --- fine-scale volumes + global saturation value ----------------------
    if cfg.cost_method == CostMethod.GRD and not aggregated:
        # row-band build (full width); column block + halos sliced out,
        # row halos exchanged with mesh neighbors
        l_rgb = bgr_to_rgb(imgs_roww[0])
        r_rgb = bgr_to_rgb(imgs_roww[1])
        vols_roww = jnp.stack(
            [build_volume(l_rgb, r_rgb, cfg.max_dis, cfg, right=False),
             build_volume(l_rgb, r_rgb, cfg.max_dis, cfg, right=True)])
        vols_cb = _col_block(vols_roww, hw)
        ext_vols = jax.vmap(lambda x: extend_rows(x, hw))(vols_cb)
        vols = vols_cb[:, :, hw:hw + ws] if n_tx > 1 else vols_cb
    else:
        # census wraps at global borders and aggregation filters span
        # rows: build from the gathered views, slice the block + halo
        lf, rf = bgr_to_rgb(full_imgs[0]), bgr_to_rgb(full_imgs[1])
        vl = build_volume(lf, rf, cfg.max_dis, cfg, right=False)
        vr = build_volume(lf, rf, cfg.max_dis, cfg, right=True)
        vl = aggregate_volume(vl, full_imgs[0], cfg)
        vr = aggregate_volume(vr, full_imgs[1], cfg)
        vols_full = jnp.stack([vl, vr])
        ext_vols = _col_block(
            jax.vmap(lambda x: _ext_from_full(x, row0, hs, hw))(vols_full),
            hw)
        vols = ext_vols[:, hw:hw + hs,
                        hw:hw + ws] if n_tx > 1 else ext_vols[:, hw:hw + hs]
    max_cost = jax.lax.pmax(jnp.max(vols, axis=(1, 2, 3)),
                            spatial_axes)  # [2]

    # --- static halos: image + volume, and row/column validity -------------
    imgs_cb = _col_block(imgs_roww, hw)
    ext_imgs = jax.vmap(lambda x: extend_rows(x, hw))(imgs_cb)
    # ASW weight image for the cost evaluators: the per-pixel Lab
    # conversion under cfg.use_lab_weights (USE_LAB_WGT capability;
    # pointwise, so converting the halo-extended block equals converting
    # the global image and slicing).  ext_imgs itself stays BGR for the
    # weighted median (reference behavior either way).
    if cfg.use_lab_weights:
        from ..ops.color import bgr_to_lab_u8
        wgt_ext = bgr_to_lab_u8(ext_imgs)
    else:
        wgt_ext = ext_imgs
    g_row = row0 + jnp.arange(-hw, hs + hw)
    row_valid = (g_row >= 0) & (g_row < h_glob)
    g_col = col0 + jnp.arange(-hw, ws + hw)
    col_valid = (g_col >= 0) & (g_col < w_glob)

    # --- coarse scales: replicated pyramids + volumes ----------------------
    if cfg.use_cs:
        from ..ops.pyramid import build_pyramid
        from ..ops.scale_weights import scale_weights

        l_pyr = build_pyramid(full_imgs[0], levels)
        r_pyr = build_pyramid(full_imgs[1], levels)
        wgts = tuple(float(x) for x in
                     scale_weights(levels, cfg.reg_lambda))
        coarse_imgs, coarse_vols, coarse_mcs = [], [], []
        md = cfg.max_dis
        for scl in range(1, levels):
            md //= 2
            ls, rs = bgr_to_rgb(l_pyr[scl]), bgr_to_rgb(r_pyr[scl])
            v_s = jnp.stack(
                [aggregate_volume(build_volume(ls, rs, md, cfg, right=False),
                                  l_pyr[scl], cfg),
                 aggregate_volume(build_volume(ls, rs, md, cfg, right=True),
                                  r_pyr[scl], cfg)])
            coarse_imgs.append(jnp.stack([l_pyr[scl], r_pyr[scl]]))
            coarse_vols.append(v_s)
            coarse_mcs.append(jnp.max(v_s, axis=(1, 2, 3)))
        if cfg.use_lab_weights:
            from ..ops.color import bgr_to_lab_u8
            coarse_wimgs = [bgr_to_lab_u8(im) for im in coarse_imgs]
        else:
            coarse_wimgs = coarse_imgs

    sparse_fn = None   # prescreen evaluator
    if cfg.prescreen_mode == "volume" and cfg.prescreen_stride > 1:
        # Quadrant-volume prescreen on the halo-extended block: neighbor
        # halo pixels are valid window context, pixels past the global
        # border are not (ops.prescreen_volume).  For cross-scale configs
        # the ranking uses the FINE level only (heuristic; exact CS
        # adoption costs are unchanged).
        from ..ops.prescreen_volume import (build_quadrant_volumes,
                                            quadrant_prescreen_cost)
        if n_tx > 1:
            valid2d = row_valid[:, None] & col_valid[None, :]
        else:
            valid2d = jnp.broadcast_to(row_valid[:, None],
                                       (row_valid.shape[0], ws))
        build = functools.partial(build_quadrant_volumes, half_wnd=hw,
                                  gamma=cfg.wgt_gamma,
                                  stride=max(cfg.prescreen_stride, 1))
        bq_e, wq_e = jax.vmap(lambda i, v2: build(i, v2, valid2d))(
            wgt_ext, ext_vols)
        csl = slice(hw, hw + ws) if n_tx > 1 else slice(None)
        bq_c = bq_e[:, :, hw:hw + hs, csl]
        wq_c = wq_e[:, :, hw:hw + hs, csl]
        rank = functools.partial(quadrant_prescreen_cost, half_wnd=hw,
                                 max_dis=cfg.max_dis)

        def sparse_fn(abc2: jax.Array) -> jax.Array:
            return jax.vmap(rank)(bq_c, wq_c, max_cost, abc2)

    if cost_backend(cfg) == "pallas":
        # Fused kernel on the block: output pixel (y, x) centres at array
        # (y + halo, x + halo); neighbor-halo rows/columns are valid image
        # pixels, pixels past the global border are not -- expressed as
        # the [ylo, yhi, xlo, xhi) array interval.  Coarse levels are
        # whole replicated images indexed at the block's global offset.
        from ..ops.pallas import window_cost as wc
        prep0 = wc.prepare(wgt_ext, ext_vols, pm.vol_dtype(cfg))
        cx0 = hw if n_tx > 1 else 0
        origin0 = (hw, cx0)
        bounds0 = jnp.stack([hw - row0, hw + h_glob - row0,
                             cx0 - col0, cx0 + w_glob - col0])
        kw = dict(half_wnd=hw, max_dis=cfg.max_dis, gamma=cfg.wgt_gamma)
        if cfg.use_cs:
            preps = [prep0] + [wc.prepare(i, v, pm.vol_dtype(cfg))
                               for i, v in zip(coarse_wimgs, coarse_vols)]
            mcs = [max_cost] + coarse_mcs
            origins = [origin0] + [(row0, col0)] * (levels - 1)
            bounds_s = [bounds0] + [None] * (levels - 1)

            def cost_fn(abc2: jax.Array) -> jax.Array:
                return wc.cross_scale_cost_prepared(
                    preps, mcs, wgts, abc2, origins=origins,
                    bounds_s=bounds_s, **kw)
        else:
            def cost_fn(abc2: jax.Array) -> jax.Array:
                return wc.window_cost_prepared(
                    prep0, max_cost, abc2, origin=origin0, bounds=bounds0,
                    **kw)

            if cfg.prescreen_stride > 1 and sparse_fn is None:
                def sparse_fn(abc2: jax.Array) -> jax.Array:
                    return wc.window_cost_prepared(
                        prep0, max_cost, abc2, origin=origin0,
                        bounds=bounds0, wnd_stride=cfg.prescreen_stride,
                        **kw)
    else:
        from ..ops.plane_cost import (upsample_level, upsample_valid,
                                      window_plane_cost_upsampled)
        jnp_kw = dict(center_row0=hw, row_valid=row_valid)
        if n_tx > 1:
            jnp_kw.update(center_col0=hw, col_valid=col_valid)

        def cost_fn(abc2: jax.Array) -> jax.Array:
            fn = functools.partial(window_plane_cost, half_wnd=hw,
                                   max_dis=cfg.max_dis, gamma=cfg.wgt_gamma,
                                   **jnp_kw)
            total = jax.vmap(fn)(wgt_ext, ext_vols, max_cost, abc2)
            if not cfg.use_cs:
                return total
            total = jnp.float32(wgts[0]) * total
            md = cfg.max_dis
            for scl in range(1, levels):
                md //= 2

                def per_view(img_s, vol_s, mc_s, abc, scl=scl, md=md):
                    iu = upsample_level(img_s, scl, hw, (hs, ws), row0, col0)
                    vu = upsample_level(vol_s, scl, hw, (hs, ws), row0, col0)
                    valid = upsample_valid(scl, hw, (hs, ws),
                                           img_s.shape[:2], row0, col0)
                    return window_plane_cost_upsampled(
                        iu, vu, valid, mc_s, abc, scale=scl, half_wnd=hw,
                        max_dis_s=md, gamma=cfg.wgt_gamma)

                cost_s = jax.vmap(per_view)(
                    coarse_wimgs[scl - 1], coarse_vols[scl - 1],
                    coarse_mcs[scl - 1], abc2)
                total = total + jnp.float32(wgts[scl]) * cost_s
            return total

        if (cfg.prescreen_stride > 1 and not cfg.use_cs
                and sparse_fn is None):
            def sparse_fn(abc2: jax.Array) -> jax.Array:
                fn = functools.partial(
                    window_plane_cost, half_wnd=hw, max_dis=cfg.max_dis,
                    gamma=cfg.wgt_gamma,
                    wnd_stride=cfg.prescreen_stride, **jnp_kw)
                return jax.vmap(fn)(wgt_ext, ext_vols, max_cost, abc2)

    if cfg.use_cs and cfg.prescreen_mode != "volume":
        sparse_fn = None     # the window prescreen is single-scale only

    # --- optimizer --------------------------------------------------------
    # Iteration-level slicing (it_lo/it_hi) + external state support the
    # sharded checkpoint/resume driver (checkpoint.run_batch_sharded_
    # resumable): keys are pre-split from the run seed once, so iterations
    # it_lo..it_hi replay identically whether or not the process restarted.
    # Rank-adoption scheduling (models.patchmatch.patchmatch): iterations
    # [0, n_rank) adopt on the quadrant ranking costs (sparse_fn as the
    # metric), the rest on exact costs, with one exact state-cost refresh
    # at the boundary.  The it_lo/it_hi checkpoint slices stay coherent:
    # a state saved inside the rank phase holds rank-unit costs and the
    # refresh replays whenever a slice crosses the boundary.
    n_rank = cfg.rank_iters if sparse_fn is not None else 0
    # deferred-cost entry into the exact phase (see
    # models.patchmatch.patchmatch): the exact-phase entry cost rides the
    # first exact sweep's include_current launch instead of a standalone
    # K=1 evaluation
    defer = cfg.prop_sweeps > 0 and cfg.max_iter > n_rank

    k_init, k_loop = jax.random.split(key)
    if state_in is None:
        init_fn = sparse_fn if n_rank else (None if defer else cost_fn)
        state = pm.init_state(k_init, (hs, ws), init_fn, cfg)
    else:
        state = pm.PMState(abc=state_in[0], cost=state_in[1])

    def sweep(state: pm.PMState, i: int, cf, sf, extra=None,
              include_current: bool = False) -> pm.PMState:
        # the stencil is axis-aligned, so row offsets come from the
        # row-extended field and (when columns are sharded) column offsets
        # from the column-extended one; corners are never needed
        ext_r = jax.vmap(lambda a: _extend_planes(a, far, hs))(state.abc)
        if n_tx > 1:
            ext_c = jax.vmap(
                lambda a: _extend_planes_cols(a, far, ws))(state.abc)
        cands = []
        for dy, dx in pm._stencil(cfg, i):
            if dx != 0 and n_tx > 1:
                cands.append(jnp.roll(ext_c, dx, axis=2)[:, :,
                                                         far:far + ws])
            else:
                cands.append(jnp.roll(ext_r, (dy, dx),
                                      axis=(1, 2))[:, far:far + hs])
        cand_abc = pm._prescreen(jnp.stack(cands, axis=1), sf)
        if include_current:
            # prepended: a cost tie keeps the current plane (see
            # models.patchmatch.spatial_sweep)
            cand_abc = jnp.concatenate([state.abc[:, None], cand_abc],
                                       axis=1)
        if extra is not None:
            cand_abc = jnp.concatenate([cand_abc, extra], axis=1)
        return pm._adopt(state, cand_abc, cf(cand_abc))

    def _abc_global_x(abc):
        """tx-all-gathered plane rows re-anchored to global x:
        c_glob = c - a * (block * Ws)."""
        abc_g = jax.lax.all_gather(abc, "tx", axis=2, tiled=True)
        xoff = ((jnp.arange(w_glob) // ws) * ws).astype(jnp.float32)
        return abc_g.at[..., 2].add(-abc_g[..., 0] * xoff[None, None, :])

    def view_cands_tx(state: pm.PMState) -> jax.Array:
        """Cross-view plane-transfer candidates when columns are sharded:
        the x-warp gather crosses tx shards, so it runs on full-width
        (global-x) plane rows and the local column block is sliced back
        out (semantics of models.patchmatch.view_candidates)."""
        abc_g = _abc_global_x(state.abc)
        ys = jax.lax.broadcasted_iota(jnp.float32, (hs, w_glob), 0)
        xs = jax.lax.broadcasted_iota(jnp.float32, (hs, w_glob), 1)

        def per_view(abc_v, abc_other, sign):
            d_own = jnp.clip(plane.disparity_at(abc_v, xs, ys),
                             0.0, cfg.max_dis - 1.0)
            xw = (xs.astype(jnp.int32)
                  + sign * jnp.rint(d_own).astype(jnp.int32)) % w_glob
            src = jnp.take_along_axis(abc_other, xw[..., None], axis=1)
            d_src = jnp.clip(
                plane.disparity_at(src, xw.astype(jnp.float32), ys),
                0.0, cfg.max_dis - 1.0)
            return plane.reanchor(src, xs, ys, d_src)

        cand = jnp.stack([per_view(abc_g[0], abc_g[1], -1),
                          per_view(abc_g[1], abc_g[0], +1)])
        cand = jax.lax.dynamic_slice_in_dim(cand, col0, ws, axis=2)
        cand = cand.at[..., 2].add(cand[..., 0] * col0)   # back to local x
        return cand[:, None]

    def view_cands(state: pm.PMState) -> jax.Array:
        return (view_cands_tx(state) if n_tx > 1
                else pm.view_candidates(state, cfg))

    def iteration(cf, sf, include_current=False):
        def step(state, it_key):
            for i in range(cfg.prop_sweeps):
                merge = cfg.merge_view and i == cfg.prop_sweeps - 1
                state = sweep(state, i, cf, sf,
                              extra=view_cands(state) if merge else None,
                              include_current=include_current and i == 0)
            if not (cfg.merge_view and cfg.prop_sweeps > 0):
                cand_abc = view_cands(state)
                state = pm._adopt(state, cand_abc, cf(cand_abc))
            state = pm.plane_refinement(state, it_key, cf, cfg,
                                        sparse_fn=sf)
            return state, None
        return step

    hi = cfg.max_iter if it_hi is None else it_hi
    all_keys = jax.random.split(k_loop, cfg.max_iter)
    keys_rank = all_keys[it_lo:min(hi, n_rank)]
    keys_exact = all_keys[max(it_lo, n_rank):hi]
    first_exact = (defer and keys_exact.shape[0]
                   and max(it_lo, n_rank) == n_rank)
    if keys_rank.shape[0]:
        state, _ = jax.lax.scan(iteration(sparse_fn, None),
                                state, keys_rank)
    if keys_exact.shape[0] and n_rank and it_lo <= n_rank:
        # crossing the rank->exact boundary: the held rank-unit cost is
        # not comparable to exact costs -- invalidate (defer) or refresh
        state = pm.PMState(
            abc=state.abc,
            cost=(jnp.full_like(state.cost, jnp.inf) if defer
                  else cost_fn(state.abc[:, None])[:, 0]))
    if first_exact:
        # iteration n_rank establishes the exact cost via include_current
        state, _ = iteration(cost_fn, sparse_fn, include_current=True)(
            state, keys_exact[0])
        keys_exact = keys_exact[1:]
    if keys_exact.shape[0]:
        state, _ = jax.lax.scan(iteration(cost_fn, sparse_fn),
                                state, keys_exact)
    if not finalize:
        return state.abc, state.cost

    dis = pm.plane_to_disp(state.abc, cfg.dis_scale)
    if cfg.use_pp:
        if n_tx > 1:
            # LR check and scanline fill are row-wide: run them on
            # full-width gathered rows, slice the local block back out
            dis_w = jax.lax.all_gather(dis, "tx", axis=2, tiled=True)
            abc_w = _abc_global_x(state.abc)
            valid_w = pp.lr_check(dis_w, cfg)
            dis_w = pp.fill_invalid(dis_w, abc_w, valid_w, cfg)
            dis = jax.lax.dynamic_slice_in_dim(dis_w, col0, ws, axis=2)
            valid = jax.lax.dynamic_slice_in_dim(valid_w, col0, ws, axis=2)
        else:
            valid = pp.lr_check(dis, cfg)
            dis = pp.fill_invalid(dis, state.abc, valid, cfg)

        def ext_hw(x):
            e = jax.vmap(lambda v: extend_rows(v, hw))(
                jax.vmap(lambda v: extend_cols(v, hw))(x)
                if n_tx > 1 else x)
            return e

        ext_dis = ext_hw(dis)
        ext_valid = ext_hw(valid) & row_valid[None, :, None]
        if n_tx > 1:
            ext_valid = ext_valid & col_valid[None, None, :]
        dis = pp.weighted_median(ext_dis, ext_imgs, ext_valid, cfg,
                                 center_row0=hw, out_h=hs,
                                 center_col0=hw if n_tx > 1 else 0,
                                 out_w=ws if n_tx > 1 else None)
    return dis


def run_batch_sharded(l_bgr: jax.Array, r_bgr: jax.Array, seeds: jax.Array,
                      cfg: CSPMConfig, mesh: Mesh) -> jax.Array:
    """Batched sharded pipeline.

    Args:
      l_bgr / r_bgr: u8[B, H, W, 3]; B divisible by mesh "data", H by
        "ty", W by "tx" (when the mesh has a "tx" axis).
      seeds: i32[B].

    Returns:
      u8[B, 2, H, W] scaled disparity maps.
    """
    shape = dict(mesh.shape)
    n_ty = shape["ty"]
    n_tx = shape.get("tx", 1)
    has_tx = "tx" in shape
    if not cfg.precompute_volume:
        if n_ty > 1 or n_tx > 1:
            raise NotImplementedError(
                "the on-the-fly GrdPC/CSPC cost supports batch data "
                "parallelism only (it has no halo form); use a "
                "(data, 1, 1) mesh or precompute_volume")
        # data-only mesh: each pair is a whole single-device pipeline --
        # shard the batch and run models.pipeline.run_pair per pair
        from ..models.pipeline import run_pair

        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P("data"), P("data"), P("data")),
            out_specs=P("data"))
        def fly_fn(l_blk, r_blk, seed_blk):
            return jax.vmap(
                lambda l1, r1, s: run_pair(l1, r1, s, cfg)["dis"])(
                    l_blk, r_blk, seed_blk)

        return fly_fn(l_bgr, r_bgr, seeds)

    # check_vma only where it must be off: pallas_call outputs carry no
    # varying-axes metadata, which the vma checker (on by default) rejects
    # under shard_map -- but the jnp path keeps the checker so it still
    # catches real sharding bugs there.
    pallas_active = cost_backend(cfg) == "pallas"
    img_spec = P("data", "ty", "tx") if has_tx else P("data", "ty")
    out_spec = (P("data", None, "ty", "tx") if has_tx
                else P("data", None, "ty", None))

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(img_spec, img_spec, P("data")),
        out_specs=out_spec, check_vma=not pallas_active)
    def fn(l_blk, r_blk, seed_blk):
        return jax.vmap(
            lambda l1, r1, s: _pair_sharded(l1, r1, s, cfg, n_ty, n_tx,
                                            has_tx))(
                l_blk, r_blk, seed_blk)

    return fn(l_bgr, r_bgr, seeds)


def run_batch_sharded_steps(l_bgr: jax.Array, r_bgr: jax.Array,
                            seeds: jax.Array, cfg: CSPMConfig, mesh: Mesh,
                            state=None, it_lo: int = 0,
                            it_hi: int | None = None,
                            finalize: bool = False):
    """Partial sharded pipeline for checkpoint/resume drivers.

    Runs outer iterations [it_lo, it_hi) starting from `state` (a global
    (abc u8?[B,2,H,W,3], cost [B,2,H,W]) pair sharded like the images, or
    None for random init at iteration 0) and returns the updated state --
    or, with finalize=True, the final disparity maps like
    run_batch_sharded.  Iteration keys are pre-split from the seeds, so
    composing calls over [0,a) then [a,b) reproduces the uninterrupted
    run bit-exactly (same property as checkpoint.run_pair_resumable).
    """
    if not cfg.precompute_volume:
        raise NotImplementedError(
            "the sharded checkpoint/resume path supports precomputed "
            "volumes only (the on-the-fly path runs via run_batch_sharded "
            "on a data-only mesh, without iteration slicing)")
    shape = dict(mesh.shape)
    n_ty = shape["ty"]
    n_tx = shape.get("tx", 1)
    has_tx = "tx" in shape
    pallas_active = cost_backend(cfg) == "pallas"
    tx_ax = "tx" if has_tx else None
    img_spec = P("data", "ty", tx_ax)
    state_specs = (P("data", None, "ty", tx_ax, None),
                   P("data", None, "ty", tx_ax))
    out_specs = (P("data", None, "ty", tx_ax) if finalize else state_specs)
    in_specs = (img_spec, img_spec, P("data"))
    args = (l_bgr, r_bgr, seeds)
    if state is not None:
        in_specs = in_specs + (state_specs,)
        args = args + (state,)

    @functools.partial(shard_map, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=not pallas_active)
    def fn(l_blk, r_blk, seed_blk, *st):
        st_blk = st[0] if st else None

        def one(l1, r1, sd, *st1):
            return _pair_sharded(l1, r1, sd, cfg, n_ty, n_tx, has_tx,
                                 state_in=st1[0] if st1 else None,
                                 it_lo=it_lo, it_hi=it_hi,
                                 finalize=finalize)

        if st_blk is not None:
            return jax.vmap(one)(l_blk, r_blk, seed_blk, st_blk)
        return jax.vmap(one)(l_blk, r_blk, seed_blk)

    return fn(*args)


def jit_run_batch_sharded(cfg: CSPMConfig, mesh: Mesh):
    """jit-wrapped runner with cfg/mesh bound statically."""
    return jax.jit(functools.partial(run_batch_sharded, cfg=cfg, mesh=mesh))


def run_sequence_batch(frames, cfg: CSPMConfig, mesh: Mesh, seed: int = 0,
                       warm_iters: int = 1):
    """Batched video serving: B independent streams over a data-only mesh.

    Cold-starts every stream on the first frame, then warm-starts each
    subsequent frame from its own stream's previous plane field.  Stream
    b's trajectory is bit-identical to a standalone
    models.pipeline.run_sequence_np(seed + 1000003*b) run (the per-stream
    seed offset decorrelates the streams' RNG).

    Args:
      frames: iterable of (left u8[B, H, W, 3], right u8[B, H, W, 3])
        batches -- frame t of all B streams; B divisible by mesh "data".
      mesh: a (data, 1, 1) mesh (each stream is a whole single-device
        pipeline; spatial sharding of warm frames is not supported).

    Yields per frame: dict with "dis" u8[B, 2, H, W] and "abc"
    f32[B, 2, H, W, 3].
    """
    shape = dict(mesh.shape)
    if shape["ty"] > 1 or shape.get("tx", 1) > 1:
        raise NotImplementedError(
            "run_sequence_batch shards streams over 'data' only; use a "
            "(data, 1, 1) mesh")
    from ..models.pipeline import run_pair, run_pair_warm

    spec = P("data")
    check = cost_backend(cfg) != "pallas"

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(spec, spec, spec),
                       out_specs=(spec, spec), check_vma=check)
    def cold(l_blk, r_blk, seed_blk):
        out = jax.vmap(lambda l1, r1, s: run_pair(l1, r1, s, cfg))(
            l_blk, r_blk, seed_blk)
        return out["dis"], out["abc"]

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(spec, spec, spec, spec),
                       out_specs=(spec, spec), check_vma=check)
    def warm(l_blk, r_blk, seed_blk, abc_blk):
        out = jax.vmap(
            lambda l1, r1, s, a: run_pair_warm(l1, r1, s, a, cfg,
                                               warm_iters=warm_iters))(
                l_blk, r_blk, seed_blk, abc_blk)
        return out["dis"], out["abc"]

    abc = None
    for i, (l, r) in enumerate(frames):
        b = l.shape[0]
        seeds = jnp.full((b,), seed + i, jnp.int32) + jnp.arange(
            b, dtype=jnp.int32) * 1000003
        if abc is None:
            dis, abc = cold(jnp.asarray(l), jnp.asarray(r), seeds)
        else:
            dis, abc = warm(jnp.asarray(l), jnp.asarray(r), seeds, abc)
        yield {"dis": dis, "abc": abc}
