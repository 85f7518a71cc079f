"""Prime the persistent compile cache for the production config set.

Cold compiles dominate a first run.  This tool compiles -- running each
full-size pipeline once -- the kernel/pipeline instantiations the shipped
configs need, so every later `bench.py`, `eval.py`, or serving call hits
the persistent compile cache (JAX_COMPILATION_CACHE_DIR, else
`.jax_cache`):

  * README-demo GRD pipeline at cones geometry (the bench headline)
  * the same via run_pairs (batch serving wraps the same program in
    lax.map -> separate XLA program, same kernels)
  * CEN + cross-scale + post-processing pipeline
  * KITTI-geometry GRD (d=128)

Usage: python tools/prime_cache.py [--quick]   (--quick: bench config only)
"""
import argparse
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="bench headline config only")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from crossscalepatchmatch.backend import enable_compile_cache

    cache = enable_compile_cache()

    from crossscalepatchmatch import CSPMConfig, CostMethod
    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.models.pipeline import run_pair, run_pairs

    jobs = [("bench_grd", 375, 450, 60,
             dict(max_dis=60, dis_scale=4, cost_method=CostMethod.GRD))]
    if not args.quick:
        jobs += [
            ("cen_cs_pp", 375, 450, 60,
             dict(max_dis=60, dis_scale=4, cost_method=CostMethod.CEN,
                  use_cs=True, scale_num=5, reg_lambda=0.3, use_pp=True)),
            ("kitti_grd_pp", 375, 1242, 128,
             dict(max_dis=128, dis_scale=2, cost_method=CostMethod.GRD,
                  use_pp=True)),
        ]

    for name, h, w, md, kw in jobs:
        pair = make_pair(h=h, w=w, max_dis=md, seed=0)
        l, r = jnp.asarray(pair.left), jnp.asarray(pair.right)
        cfg = CSPMConfig(**kw)
        t0 = time.perf_counter()
        out = run_pair(l, r, jnp.int32(0), cfg)
        jax.block_until_ready(out)
        print(f"prime {name}: {time.perf_counter()-t0:.1f}s", flush=True)
        if name == "bench_grd":
            t0 = time.perf_counter()
            out = run_pairs(l[None], r[None], jnp.zeros((1,), jnp.int32),
                            cfg)
            jax.block_until_ready(out)
            print(f"prime {name} (batch serving): "
                  f"{time.perf_counter()-t0:.1f}s", flush=True)
    print("cache primed:", cache)


if __name__ == "__main__":
    main()
