"""Scaling benchmark for the sharded (mesh) pipeline.

Measures stereo pairs/s on 1 device vs all visible devices (up to four
cards of one host, joined all to all).  On a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=N) the numbers measure
the mechanism, not the hardware, and are labeled as such.

Usage:
  python bench_scaling.py [--h 384] [--w 448] [--max_dis 60] [--batch 0]
With --batch N > 0 a fixed batch of N pairs is sharded over the "data"
axis; otherwise a single pair is row-sharded over all devices.  Both are
strong-scaling measurements (fixed total work, growing device count).

Prints one JSON line per mesh configuration.
"""

import argparse
import json
import sys
import time


def run(mesh, cfg, pairs_l, pairs_r, seeds):
    import jax

    from crossscalepatchmatch.parallel.tiled import jit_run_batch_sharded

    fn = jit_run_batch_sharded(cfg, mesh)
    jax.block_until_ready(fn(pairs_l, pairs_r, seeds))   # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(fn(pairs_l, pairs_r, seeds + 1))
    return time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=384)
    ap.add_argument("--w", type=int, default=448)
    ap.add_argument("--max_dis", type=int, default=60)
    ap.add_argument("--wnd", type=int, default=35)
    ap.add_argument("--batch", type=int, default=0,
                    help=">0: shard a fixed batch of N pairs over 'data'")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from crossscalepatchmatch.backend import enable_compile_cache

    enable_compile_cache()

    from crossscalepatchmatch import CSPMConfig, CostMethod
    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.parallel.mesh import make_mesh

    n_dev = len(jax.devices())
    plat = jax.devices()[0].platform
    kind = jax.devices()[0].device_kind
    cfg = CSPMConfig(max_dis=args.max_dis, dis_scale=4, wnd_size=args.wnd,
                     cost_method=CostMethod.GRD)

    def mk_batch(b):
        ps = [make_pair(h=args.h, w=args.w, max_dis=args.max_dis, seed=s)
              for s in range(b)]
        return (jnp.stack([jnp.asarray(p.left) for p in ps]),
                jnp.stack([jnp.asarray(p.right) for p in ps]),
                jnp.arange(b, dtype=jnp.int32))

    results = []
    if args.batch > 0:      # fixed batch sharded over "data" (strong scaling)
        for n in sorted({1, n_dev}):
            if args.batch % n:
                continue
            l, r, s = mk_batch(args.batch)
            dt = run(make_mesh(n, 1), cfg, l, r, s)
            results.append((f"data={n}", args.batch / dt))
    else:                   # strong scaling: one pair's rows over "ty"
        l, r, s = mk_batch(1)
        for n in sorted({1, n_dev}):
            if args.h % n or args.h // n < cfg.half_wnd:
                continue
            dt = run(make_mesh(1, n), cfg, l, r, s)
            results.append((f"ty={n}", 1.0 / dt))

    base = results[0][1]
    for name, pps in results:
        n = int(name.split("=")[1])
        eff = pps / (base * n) if n > 1 else 1.0
        print(json.dumps({
            "metric": "sharded_pairs_per_second", "mesh": name,
            "value": round(pps, 4), "efficiency_vs_1dev": round(eff, 3),
            "device": {"platform": plat, "kind": kind, "count": n_dev},
            "note": ("virtual CPU mesh -- mechanism only" if plat == "cpu"
                     else "real devices"),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
