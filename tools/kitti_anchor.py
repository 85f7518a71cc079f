"""Production-size oracle parity anchor (VERDICT round-4, item 4).

The eval.py matrix bounds the engine-vs-oracle delta only on <=192x416
scenes; the reference semantics that matter at LARGE disparity -- the
max_dis/2 refinement start (cs_patchmatch.cc:292-345) and the border
columns at large d (grd_cc.cpp:21-35) -- were never oracle-compared at
production geometry.  This driver runs the native oracle
(csrc/cspm_oracle.cc) and the engine on ONE KITTI-like synthetic
scene (default 256x832, max_dis=96, GRD + post-processing) and scores
both @3px (the KITTI convention) against the synthetic ground truth.

The oracle side is O(hours) on this single-core host, so its per-seed
scores are cached in tools/.kitti_anchor_cache.json keyed by the scene
geometry -- run once with --oracle-only (background), then score the
engine against the cache with --engine-only.

Usage:
  python tools/kitti_anchor.py --oracle-only     # hours; cached
  python tools/kitti_anchor.py --engine-only     # scores engine vs cache
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".kitti_anchor_cache.json")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--w", type=int, default=832)
    ap.add_argument("--max_dis", type=int, default=96)
    ap.add_argument("--dis_scale", type=int, default=2)
    ap.add_argument("--cc", default="GRD")
    ap.add_argument("--oracle-seeds", type=int, default=2)
    ap.add_argument("--engine-seeds", type=int, default=5)
    ap.add_argument("--oracle-only", action="store_true")
    ap.add_argument("--engine-only", action="store_true")
    ap.add_argument("--thresh", type=float, default=3.0,
                    help="bad-pixel threshold (KITTI convention: 3 px)")
    args = ap.parse_args()

    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.metrics import bad_pixel_rate

    key = f"{args.h}x{args.w}_d{args.max_dis}_{args.cc}_pp"
    pair = make_pair(h=args.h, w=args.w, max_dis=args.max_dis, seed=7)

    cache = {}
    if os.path.exists(CACHE):
        with open(CACHE) as f:
            cache = json.load(f)
    entry = cache.get(key, {"oracle": {}})

    if not args.engine_only:
        from crossscalepatchmatch import oracle
        for seed in range(args.oracle_seeds):
            if str(seed) in entry["oracle"]:
                continue
            t0 = time.perf_counter()
            dis = oracle.run_pair(
                pair.left, pair.right, max_dis=args.max_dis,
                dis_scale=args.dis_scale, cc_name=args.cc, use_cs=False,
                use_pp=True, seed=seed)
            dt = time.perf_counter() - t0
            bad = bad_pixel_rate(
                np.asarray(dis[0], np.float32) / args.dis_scale,
                pair.disp_left, pair.valid_left, args.thresh)
            entry["oracle"][str(seed)] = [bad, dt]
            cache[key] = entry
            with open(CACHE, "w") as f:
                json.dump(cache, f, indent=1)
            print(f"oracle seed {seed}: bad@{args.thresh:g} {bad:.4f} "
                  f"({dt:.0f}s)", flush=True)

    if args.oracle_only:
        return 0

    if not entry["oracle"]:
        print("no cached oracle scores; run --oracle-only first",
              file=sys.stderr)
        return 1

    from crossscalepatchmatch import CSPMConfig, CostMethod
    from crossscalepatchmatch.models.pipeline import run_pair_np
    cfg = CSPMConfig(max_dis=args.max_dis, dis_scale=args.dis_scale,
                     cost_method=CostMethod[args.cc], use_cs=False,
                     use_pp=True)
    bads, t_last = [], 0.0
    for seed in range(args.engine_seeds):
        t0 = time.perf_counter()
        out = run_pair_np(pair.left, pair.right, cfg, seed=seed)
        t_last = time.perf_counter() - t0
        bads.append(bad_pixel_rate(
            out["dis"][0].astype(np.float32) / args.dis_scale,
            pair.disp_left, pair.valid_left, args.thresh))

    bads_o = [v[0] for v in entry["oracle"].values()]
    bad_o, bad_e = float(np.mean(bads_o)), float(np.mean(bads))
    # bootstrap 95% upper CI on the delta of means (same protocol as
    # eval.py: the bound must hold on the CI upper end)
    brng = np.random.default_rng(0)
    e_s, o_s = np.asarray(bads, float), np.asarray(bads_o, float)
    d_bs = (brng.choice(e_s, (10000, e_s.size)).mean(axis=1)
            - brng.choice(o_s, (10000, o_s.size)).mean(axis=1))
    ci_hi = float(np.quantile(d_bs, 0.975))
    result = dict(metric="kitti_anchor_bad3_delta_vs_oracle",
                  scene=key, bad_oracle=round(bad_o, 4),
                  bad_engine=round(bad_e, 4),
                  delta=round(bad_e - bad_o, 4),
                  delta_ci95_hi=round(ci_hi, 4), bound=0.005,
                  oracle_seeds=len(bads_o), engine_seeds=len(bads),
                  t_oracle_s=round(float(np.mean(
                      [v[1] for v in entry["oracle"].values()])), 0),
                  t_engine_s=round(t_last, 2))
    print(json.dumps(result))
    return 0 if ci_hi <= 0.005 else 1


if __name__ == "__main__":
    sys.exit(main())
