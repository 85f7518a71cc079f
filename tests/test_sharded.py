"""Sharded-vs-reference consistency on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from crossscalepatchmatch import CSPMConfig, CostMethod
from crossscalepatchmatch.data import make_pair
from crossscalepatchmatch.metrics import bad_pixel_rate
from crossscalepatchmatch.parallel.mesh import make_mesh
from crossscalepatchmatch.models.pipeline import run_pair_np
from crossscalepatchmatch.parallel.tiled import (
    extend_rows, jit_run_batch_sharded)


requires_8_devices = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices")


def small_cfg(**kw):
    base = dict(max_dis=12, dis_scale=16, wnd_size=11,
                cost_method=CostMethod.GRD, use_cs=False, use_pp=False,
                max_iter=2)
    base.update(kw)
    return CSPMConfig(**base)


@requires_8_devices
class TestHaloExchange:
    def test_extend_rows_roundtrip(self):
        mesh = make_mesh(1, 8)
        x = jnp.arange(8 * 4 * 3, dtype=jnp.float32).reshape(8 * 4, 3)

        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        @jax.jit
        def f(x):
            return shard_map(lambda b: extend_rows(b, 2),
                             mesh=mesh, in_specs=P("ty", None),
                             out_specs=P("ty", None))(x)

        out = np.asarray(f(x))
        xs = np.asarray(x).reshape(8, 4, 3)
        out = out.reshape(8, 8, 3)
        # interior shard: halo rows match neighbors' edge rows
        np.testing.assert_array_equal(out[3, :2], xs[2, -2:])
        np.testing.assert_array_equal(out[3, 2:6], xs[3])
        np.testing.assert_array_equal(out[3, 6:], xs[4, :2])
        # edge shards: zero halos
        np.testing.assert_array_equal(out[0, :2], np.zeros((2, 3)))
        np.testing.assert_array_equal(out[7, 6:], np.zeros((2, 3)))

    def test_extend_rows_multi_hop(self):
        # halo (10) taller than the band (4): served by 3-hop exchange,
        # never truncated
        mesh = make_mesh(1, 8)
        halo = 10
        x = jnp.arange(8 * 4 * 2, dtype=jnp.float32).reshape(8 * 4, 2)

        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        @jax.jit
        def f(x):
            return shard_map(lambda b: extend_rows(b, halo),
                             mesh=mesh, in_specs=P("ty", None),
                             out_specs=P("ty", None))(x)

        out = np.asarray(f(x)).reshape(8, 4 + 2 * halo, 2)
        xf = np.asarray(x)
        # interior shard 4 (rows 16..19): extended = global rows 6..29
        np.testing.assert_array_equal(out[4], xf[6:30])
        # shard 1 (rows 4..7): top halo rows beyond the image are zero
        want = np.concatenate([np.zeros((6, 2), np.float32), xf[:18]])
        np.testing.assert_array_equal(out[1], want)


@requires_8_devices
class TestShardedPipeline:
    def test_matches_quality_of_single_device(self):
        pair = make_pair(h=64, w=64, max_dis=12, seed=11)
        cfg = small_cfg()
        mesh = make_mesh(1, 8)   # 8 row bands of 8 rows
        run = jit_run_batch_sharded(cfg, mesh)
        l = jnp.asarray(pair.left)[None]
        r = jnp.asarray(pair.right)[None]
        dis = np.asarray(run(l, r, jnp.zeros((1,), jnp.int32)))
        assert dis.shape == (1, 2, 64, 64)
        disp = dis[0, 0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        # multi-hop halo exchange preserves the full far-ring stencil, so
        # sharded quality must match the single-device threshold
        # (tests/test_engine.py uses 0.15 on comparable scenes)
        assert bad < 0.15, f"sharded bad-pixel rate too high: {bad:.3f}"

    def test_rank_exact_adoption_sharded(self):
        # rank+exact adoption scheduling inside the sharded optimizer
        pair = make_pair(h=64, w=64, max_dis=12, seed=11)
        cfg = small_cfg(adopt_mode="rank+exact")
        mesh = make_mesh(1, 4)
        run = jit_run_batch_sharded(cfg, mesh)
        dis = np.asarray(run(jnp.asarray(pair.left)[None],
                             jnp.asarray(pair.right)[None],
                             jnp.zeros((1,), jnp.int32)))
        disp = dis[0, 0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        assert bad < 0.15, f"sharded rank+exact bad rate {bad:.3f}"

    def test_data_parallel_batch(self):
        pairs = [make_pair(h=32, w=48, max_dis=8, seed=s) for s in (1, 2)]
        cfg = small_cfg(max_dis=8)
        mesh = make_mesh(2, 4)
        run = jit_run_batch_sharded(cfg, mesh)
        l = jnp.stack([jnp.asarray(p.left) for p in pairs])
        r = jnp.stack([jnp.asarray(p.right) for p in pairs])
        dis = np.asarray(run(l, r, jnp.array([0, 0], jnp.int32)))
        assert dis.shape == (2, 2, 32, 48)
        for i, p in enumerate(pairs):
            disp = dis[i, 0].astype(np.float32) / cfg.dis_scale
            bad = bad_pixel_rate(disp, p.disp_left, p.valid_left, 1.0)
            assert bad < 0.25, f"pair {i} bad rate {bad:.3f}"

    def test_sharded_with_postprocessing(self):
        pair = make_pair(h=32, w=48, max_dis=8, seed=4)
        cfg = small_cfg(max_dis=8, use_pp=True)
        mesh = make_mesh(1, 4)
        run = jit_run_batch_sharded(cfg, mesh)
        dis = np.asarray(run(jnp.asarray(pair.left)[None],
                             jnp.asarray(pair.right)[None],
                             jnp.zeros((1,), jnp.int32)))
        disp = dis[0, 0].astype(np.float32) / cfg.dis_scale
        bad_all = bad_pixel_rate(disp, pair.disp_left, None, 1.0)
        assert bad_all < 0.3

    def test_census_sharded_matches_single_device_quality(self):
        pair = make_pair(h=48, w=64, max_dis=8, seed=6)
        cfg = small_cfg(max_dis=8, cost_method=CostMethod.CEN)
        mesh = make_mesh(1, 4)
        dis = np.asarray(jit_run_batch_sharded(cfg, mesh)(
            jnp.asarray(pair.left)[None], jnp.asarray(pair.right)[None],
            jnp.zeros((1,), jnp.int32)))
        disp = dis[0, 0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        single = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp_s = single["dis"][0].astype(np.float32) / cfg.dis_scale
        bad_s = bad_pixel_rate(disp_s, pair.disp_left, pair.valid_left, 1.0)
        assert bad < max(2.0 * bad_s, 0.12), (bad, bad_s)

    def test_cross_scale_sharded_matches_single_device_quality(self):
        pair = make_pair(h=48, w=64, max_dis=8, seed=7)
        cfg = small_cfg(max_dis=8, use_cs=True, scale_num=2,
                        reg_lambda=0.3)
        mesh = make_mesh(1, 4)
        dis = np.asarray(jit_run_batch_sharded(cfg, mesh)(
            jnp.asarray(pair.left)[None], jnp.asarray(pair.right)[None],
            jnp.zeros((1,), jnp.int32)))
        disp = dis[0, 0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        single = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp_s = single["dis"][0].astype(np.float32) / cfg.dis_scale
        bad_s = bad_pixel_rate(disp_s, pair.disp_left, pair.valid_left, 1.0)
        assert bad < max(2.0 * bad_s, 0.12), (bad, bad_s)

    def test_aggregator_sharded_matches_single_device(self):
        # equivalence check only: box pre-aggregation composed with the
        # 11x11 ASW window double-smooths and is genuinely poor on this
        # tiny scene (~0.62 bad either way); the sharded path must simply
        # reproduce the single-device behavior of the same config
        from crossscalepatchmatch.config import Aggregator
        pair = make_pair(h=32, w=48, max_dis=8, seed=8)
        cfg = small_cfg(max_dis=8, aggregator=Aggregator.BOX)
        mesh = make_mesh(1, 4)
        dis = np.asarray(jit_run_batch_sharded(cfg, mesh)(
            jnp.asarray(pair.left)[None], jnp.asarray(pair.right)[None],
            jnp.zeros((1,), jnp.int32)))
        disp = dis[0, 0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        single = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp_s = single["dis"][0].astype(np.float32) / cfg.dis_scale
        bad_s = bad_pixel_rate(disp_s, pair.disp_left, pair.valid_left, 1.0)
        assert abs(bad - bad_s) < 0.15, (bad, bad_s)

    def test_tx_sharded_quality(self):
        # (data=1, ty=2, tx=4): 2-D spatial tiling with column halo
        # exchange; quality must match the single-device threshold
        pair = make_pair(h=64, w=64, max_dis=12, seed=11)
        cfg = small_cfg()
        mesh = make_mesh(1, 2, 4)   # 32-row bands x 16-col blocks
        run = jit_run_batch_sharded(cfg, mesh)
        dis = np.asarray(run(jnp.asarray(pair.left)[None],
                             jnp.asarray(pair.right)[None],
                             jnp.zeros((1,), jnp.int32)))
        assert dis.shape == (1, 2, 64, 64)
        disp = dis[0, 0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        assert bad < 0.15, f"tx-sharded bad-pixel rate too high: {bad:.3f}"

    def test_tx_sharded_with_postprocessing_census(self):
        # tx sharding through the census + post-processing path (row-wide
        # LR/fill on gathered rows, 2-D-halo weighted median)
        pair = make_pair(h=48, w=64, max_dis=8, seed=6)
        cfg = small_cfg(max_dis=8, cost_method=CostMethod.CEN, use_pp=True)
        mesh = make_mesh(1, 2, 2)
        dis = np.asarray(jit_run_batch_sharded(cfg, mesh)(
            jnp.asarray(pair.left)[None], jnp.asarray(pair.right)[None],
            jnp.zeros((1,), jnp.int32)))
        disp = dis[0, 0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        single = run_pair_np(pair.left, pair.right, cfg, seed=0)
        disp_s = single["dis"][0].astype(np.float32) / cfg.dis_scale
        bad_s = bad_pixel_rate(disp_s, pair.disp_left, pair.valid_left, 1.0)
        assert bad < max(2.0 * bad_s, 0.12), (bad, bad_s)

    @pytest.mark.slow
    def test_production_geometry_sharded(self):
        """PRODUCTION window/disparity geometry on the 8-device mesh:
        wnd=35 (17-px halos), max_dis=60, max_iter=2 -- with 16-row
        bands the halo EXCEEDS the block height, so every exchange is
        multi-hop and the halo-vs-tile interactions the toy-geometry
        tests never reach (SURVEY.md section 7.8) actually bite.  Slow
        (wnd=35 jnp window costs on CPU); quality must match the
        single-device threshold."""
        pair = make_pair(h=128, w=128, max_dis=60, seed=11)
        cfg = small_cfg(wnd_size=35, max_dis=60, dis_scale=4)
        mesh = make_mesh(1, 8)   # 16-row bands < 17-px halo: multi-hop
        run = jit_run_batch_sharded(cfg, mesh)
        dis = np.asarray(run(jnp.asarray(pair.left)[None],
                             jnp.asarray(pair.right)[None],
                             jnp.zeros((1,), jnp.int32)))
        assert dis.shape == (1, 2, 128, 128)
        disp = dis[0, 0].astype(np.float32) / cfg.dis_scale
        bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
        assert bad < 0.15, f"production-geometry bad rate: {bad:.3f}"

    def test_rejects_unsupported_configs(self):
        # the on-the-fly cost has no halo form: spatial sharding rejects
        mesh = make_mesh(1, 8)
        cfg = small_cfg(precompute_volume=False)
        with pytest.raises(NotImplementedError):
            jit_run_batch_sharded(cfg, mesh)(
                jnp.zeros((1, 64, 64, 3), jnp.uint8),
                jnp.zeros((1, 64, 64, 3), jnp.uint8),
                jnp.zeros((1,), jnp.int32))

    def test_sequence_batch_matches_per_stream(self):
        """Batched video serving over a data mesh: every stream's
        trajectory must equal the standalone run_sequence_np run with the
        stream's seed, bit-for-bit, across cold + warm frames."""
        from crossscalepatchmatch.models.pipeline import run_sequence_np
        from crossscalepatchmatch.parallel.tiled import (
            run_sequence_batch)

        mesh = make_mesh(2, 1, 1, devices=jax.devices()[:2])
        cfg = small_cfg()
        pairs = [make_pair(h=40, w=48, max_dis=12, seed=s) for s in (4, 9)]
        frames = [(np.stack([p.left for p in pairs]),
                   np.stack([p.right for p in pairs]))] * 3

        batched = [
            {k: np.asarray(v) for k, v in out.items()}
            for out in run_sequence_batch(frames, cfg, mesh, seed=7)]
        for b, p in enumerate(pairs):
            solo = list(run_sequence_np([(p.left, p.right)] * 3, cfg,
                                        seed=7 + 1000003 * b))
            for t in range(3):
                np.testing.assert_array_equal(batched[t]["dis"][b],
                                              solo[t]["dis"])

    def test_fly_data_parallel_matches_single_device(self):
        """precompute_volume=False on a data-only mesh runs each pair as
        a whole single-device pipeline under shard_map; outputs must be
        bit-identical to the unsharded pipeline."""
        from crossscalepatchmatch.models.pipeline import run_pair

        mesh = make_mesh(2, 1, 1, devices=jax.devices()[:2])
        cfg = small_cfg(precompute_volume=False)
        pairs = [make_pair(h=40, w=48, max_dis=12, seed=s) for s in (4, 9)]
        l = jnp.stack([jnp.asarray(p.left) for p in pairs])
        r = jnp.stack([jnp.asarray(p.right) for p in pairs])
        seeds = jnp.array([3, 5], jnp.int32)

        dis = np.asarray(jit_run_batch_sharded(cfg, mesh)(l, r, seeds))
        assert dis.shape == (2, 2, 40, 48)
        for b in range(2):
            ref = np.asarray(run_pair(l[b], r[b], seeds[b], cfg)["dis"])
            np.testing.assert_array_equal(dis[b], ref)
