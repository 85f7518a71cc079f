"""Accuracy-parity evaluation: the JAX engine vs the reference oracle.

Runs the reference's canonical config matrix (CSPM/input.txt:1-20 --
Middlebury pairs with CEN + post-processing, plus the README GRD demo)
on synthetic ground-truth scenes and scores both the native CPU oracle
(csrc/cspm_oracle.cc, reference semantics) and the engine with the
Middlebury bad-pixel metric.  The parity bound is a <= 0.5% (0.005)
bad-pixel delta between the two (PARITY.md).

Real Middlebury images cannot be redistributed in this repo and the build
host has no egress, so the scenes are procedurally generated
(crossscalepatchmatch.data.make_pair) at geometry proportional to
each config's disparity range.  Scene sizes are chosen so the O(75 * 1225
* H * W) oracle finishes in seconds per config.

Usage:  python eval.py [--quick]
Prints one row per config and a JSON summary line.
"""

import argparse
import json
import sys
import time

import numpy as np


# (name, scene h, scene w, max_dis, dis_scale, cc, use_cs, use_pp,
#  scene kwargs)
# max_dis/dis_scale/cc/pp follow input.txt; scenes are scaled-down
# synthetic stand-ins with matching disparity ranges.  Scenes are kept
# large relative to the 35-px ASW window (on ~100-px images the window
# covers a third of the scene and both implementations degrade).
# The last two rows stress failure modes the input.txt matrix lacks:
# occlusion-heavy (4 foreground objects, ~2x the occluded fraction) and
# low-texture (contrast scaled to 0.3 -- weak data term, propagation
# must carry the solution).
CONFIGS = [
    ("readme_demo_grd", 192, 256, 16, 8, "GRD", False, False, {}),
    ("tsukuba_cen_pp", 192, 256, 16, 16, "CEN", False, True, {}),
    ("venus_cen_pp", 192, 256, 20, 8, "CEN", False, True, {}),
    ("cones_cen_pp", 160, 224, 24, 4, "CEN", False, True, {}),
    ("teddy_cen_cs_pp", 160, 224, 24, 4, "CEN", True, True, {}),
    ("reindeer_cen_pp", 192, 416, 80, 3, "CEN", False, True, {}),
    ("occlusions_cen_pp", 176, 240, 24, 4, "CEN", False, True,
     {"n_fg": 4}),
    ("lowtex_grd_pp", 192, 256, 16, 8, "GRD", False, True,
     {"texture_contrast": 0.3}),
    # Realism rows (round 4): the failure axes real Middlebury/KITTI
    # pairs exercise that clean synthetic scenes lack -- sensor noise,
    # inter-camera exposure mismatch, and imperfect rectification.
    ("noisy_cen_pp", 192, 256, 20, 8, "CEN", False, True,
     {"noise_sigma": 4.0}),
    ("exposure_grd_pp", 192, 256, 16, 8, "GRD", False, True,
     {"exposure_gain": 1.15, "exposure_bias": 6.0}),
    ("rectjitter_cen_pp", 192, 256, 20, 8, "CEN", False, True,
     {"rect_jitter": 0.5}),
    # Real-photograph texture (grace_hopper.jpg via data.load_host_photo):
    # natural texture spectra / edges / camera grain with exact synthetic
    # GT geometry -- the closest this egress-less host gets to real pairs.
    ("photo_cen_pp", 192, 256, 20, 8, "CEN", False, True,
     {"photo": True}),
    ("photo_grd", 192, 256, 16, 8, "GRD", False, False,
     {"photo": True}),
]
QUICK = CONFIGS[:2]


# Scenes for the paired use_cs ablation (--cs-ablation): the conditions
# where CVPR 2014 cross-scale aggregation predicts gains -- weak data
# terms (low texture), photometric noise, and natural texture spectra
# (/root/reference/README.md:18-33; the lambda-weight machinery under
# test is pre_cs_pc.cc:85-109).  CEN + no PP isolates the aggregation
# effect from the post-processor.
CS_SCENES = [
    ("lowtex", 192, 256, 20, 8, {"texture_contrast": 0.3}),
    ("noisy", 192, 256, 20, 8, {"noise_sigma": 4.0}),
    ("noisy_lowtex", 192, 256, 20, 8,
     {"noise_sigma": 4.0, "texture_contrast": 0.5}),
    ("photo", 192, 256, 20, 8, {"photo": True}),
    ("clean", 160, 224, 24, 4, {}),
]


def cs_ablation(args):
    """Paired use_cs on/off comparison: does
    cross-scale aggregation actually help accuracy where the CVPR'14
    paper says it should?  Scores engine AND oracle both ways with a
    bootstrap CI on each CS - SS delta."""
    import os
    import zlib

    import numpy as np

    from crossscalepatchmatch import CSPMConfig, CostMethod, oracle
    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.metrics import bad_pixel_rate
    from crossscalepatchmatch.models.pipeline import run_pair_np

    cache_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              ".eval_oracle_cache.json")
    cache = {}
    if os.path.exists(cache_path) and not args.no_oracle_cache:
        with open(cache_path) as f:
            cache = json.load(f)

    brng = np.random.default_rng(0)

    def boot_delta(cs, ss):
        cs, ss = np.asarray(cs, float), np.asarray(ss, float)
        d = (brng.choice(cs, (10000, cs.size)).mean(axis=1)
             - brng.choice(ss, (10000, ss.size)).mean(axis=1))
        return (float(np.quantile(d, 0.025)), float(np.quantile(d, 0.975)))

    rows = []
    todo = CS_SCENES
    if args.only:
        names = set(args.only.split(","))
        todo = [c for c in CS_SCENES if c[0] in names]
    for name, h, w, max_dis, dis_scale, scene_kw in todo:
        cseed = zlib.crc32(name.encode()) % 1000
        scene_kw = dict(scene_kw)
        if scene_kw.pop("photo", False):
            from crossscalepatchmatch.data import (load_host_photo,
                                                       photo_textures)
            photo = load_host_photo()
            if photo is None:
                print(f"{name}: skipped (no host photo)", file=sys.stderr)
                continue
            scene_kw["textures"] = photo_textures(
                photo, 5, h, w + max_dis + 4,
                np.random.default_rng(cseed))
        pair = make_pair(h=h, w=w, max_dis=max_dis, seed=cseed, **scene_kw)

        row = {"scene": name}
        # --seeds 0 / --oracle_seeds 0 skip that side (e.g. pre-warming
        # the oracle cache on CPU while the GPU is busy elsewhere)
        sides = [s for s, n in (("engine", args.seeds),
                                ("oracle", args.oracle_seeds)) if n > 0]
        for side in sides:
            bads = {}
            for use_cs in (False, True):
                key = (f"csab/{name}/{use_cs}/{args.oracle_seeds}"
                       if side == "oracle" else None)
                if side == "oracle" and key in cache:
                    bads[use_cs] = cache[key]
                    continue
                n = args.seeds if side == "engine" else args.oracle_seeds
                scores = []
                for seed in range(n):
                    if side == "engine":
                        cfg = CSPMConfig(
                            max_dis=max_dis, dis_scale=dis_scale,
                            cost_method=CostMethod.CEN, use_cs=use_cs,
                            use_pp=False, scale_num=3 if use_cs else 5,
                            reg_lambda=0.3 if use_cs else 0.0)
                        out = run_pair_np(pair.left, pair.right, cfg,
                                          seed=seed)
                        disp = (out["dis"][0].astype(np.float32)
                                / dis_scale)
                    else:
                        dis_o = oracle.run_pair(
                            pair.left, pair.right, max_dis=max_dis,
                            dis_scale=dis_scale, cc_name="CEN",
                            use_cs=use_cs, use_pp=False,
                            reg_lambda=0.3 if use_cs else 0.0,
                            scale_num=3 if use_cs else 5, seed=seed)
                        disp = (np.asarray(dis_o[0], np.float32)
                                / dis_scale)
                    scores.append(float(bad_pixel_rate(
                        disp, pair.disp_left, pair.valid_left, 1.0)))
                bads[use_cs] = scores
                if side == "oracle":
                    cache[key] = scores
                    with open(cache_path, "w") as f:
                        json.dump(cache, f)
            lo, hi = boot_delta(bads[True], bads[False])
            row[side] = dict(
                ss=round(float(np.mean(bads[False])), 4),
                cs=round(float(np.mean(bads[True])), 4),
                delta=round(float(np.mean(bads[True])
                                  - np.mean(bads[False])), 4),
                delta_ci95=[round(lo, 4), round(hi, 4)])
            print(f"{name:14s} {side:6s} ss {row[side]['ss']:.4f}  "
                  f"cs {row[side]['cs']:.4f}  delta "
                  f"{row[side]['delta']:+.4f} "
                  f"[{lo:+.4f}, {hi:+.4f}]", file=sys.stderr, flush=True)
        rows.append(row)

    print(json.dumps({"metric": "cs_ablation_bad_pixel", "rows": rows}))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="first two configs only")
    ap.add_argument("--cs-ablation", action="store_true",
                    help="paired use_cs on/off comparison on the scenes "
                         "where cross-scale aggregation should help")
    ap.add_argument("--seeds", type=int, default=5,
                    help="engine seeds per config (mean is scored)")
    ap.add_argument("--oracle_seeds", type=int, default=5,
                    help="oracle seeds per config (mean is scored; both "
                         "sides are stochastic optimizers)")
    ap.add_argument("--adopt", default=None,
                    choices=("exact", "rank", "rank+exact"),
                    help="engine adopt_mode override (default: config "
                         "default)")
    ap.add_argument("--exact-iters", type=int, default=None,
                    help="trailing exact iterations for rank+exact")
    ap.add_argument("--refine-stages", type=int, default=None,
                    help="batched-refinement stages override")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="generic CSPMConfig field override (repeatable); "
                         "values parsed as int/float/bool when possible")
    ap.add_argument("--only", default=None,
                    help="comma-separated config-name filter")
    ap.add_argument("--no-oracle-cache", action="store_true",
                    help="recompute oracle scores even if cached")
    args = ap.parse_args()

    import jax

    from crossscalepatchmatch.backend import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"eval: device {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}", file=sys.stderr)

    if args.cs_ablation:
        return cs_ablation(args)

    from crossscalepatchmatch import CSPMConfig, CostMethod, oracle
    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.metrics import bad_pixel_rate
    from crossscalepatchmatch.models.pipeline import run_pair_np

    rows = []
    todo = QUICK if args.quick else CONFIGS
    if args.only:
        names = set(args.only.split(","))
        todo = [c for c in CONFIGS if c[0] in names]
    for (name, h, w, max_dis, dis_scale, cc, use_cs, use_pp,
         scene_kw) in todo:
        # stable per-config seed (str hash is salted per interpreter run)
        import zlib
        cseed = zlib.crc32(name.encode()) % 1000
        scene_kw = dict(scene_kw)
        if scene_kw.pop("photo", False):
            from crossscalepatchmatch.data import (load_host_photo,
                                                       photo_textures)
            photo = load_host_photo()
            if photo is None:
                print(f"{name}: skipped (no host photo available)",
                      file=sys.stderr)
                continue
            scene_kw["textures"] = photo_textures(
                photo, 5, h, w + max_dis + 4,
                np.random.default_rng(cseed))
        pair = make_pair(h=h, w=w, max_dis=max_dis, seed=cseed, **scene_kw)
        scale_num = 3 if use_cs else 5   # small scenes: 3 usable levels
        reg_lambda = 0.3 if use_cs else 0.0

        # The oracle score is deterministic per (config, seed): cache it
        # on disk so engine-side sweeps don't re-pay ~30-90 s/seed.
        import os
        cache_path = os.path.join(os.path.dirname(
            os.path.abspath(__file__)), ".eval_oracle_cache.json")
        cache = {}
        if os.path.exists(cache_path) and not args.no_oracle_cache:
            with open(cache_path) as f:
                cache = json.load(f)
        # v2 cache entries keep the PER-SEED scores (the bootstrap CI
        # below resamples them); v1 entries (mean only) are ignored.
        ckey = f"{name}/v2/{args.oracle_seeds}"
        if ckey in cache:
            bads_o, t_oracle = cache[ckey]
        else:
            t0 = time.perf_counter()
            bads_o = []
            for oseed in range(args.oracle_seeds):
                dis_o = oracle.run_pair(
                    pair.left, pair.right, max_dis=max_dis,
                    dis_scale=dis_scale, cc_name=cc, use_cs=use_cs,
                    use_pp=use_pp, reg_lambda=reg_lambda,
                    scale_num=scale_num, seed=oseed)
                bads_o.append(float(bad_pixel_rate(
                    np.asarray(dis_o[0], np.float32) / dis_scale,
                    pair.disp_left, pair.valid_left, 1.0)))
            t_oracle = (time.perf_counter() - t0) / args.oracle_seeds
            cache[ckey] = [bads_o, t_oracle]
            with open(cache_path, "w") as f:
                json.dump(cache, f)
        bad_o = float(np.mean(bads_o))

        adopt_kw = {} if args.adopt is None else dict(
            adopt_mode=args.adopt)
        if args.exact_iters is not None:
            adopt_kw["exact_iters"] = args.exact_iters
        if args.refine_stages is not None:
            adopt_kw["refine_stages"] = args.refine_stages
        for kv in args.set:
            key, _, val = kv.partition("=")
            if val in ("True", "true", "False", "false"):
                val = val in ("True", "true")
            else:
                try:
                    val = int(val)
                except ValueError:
                    try:
                        val = float(val)
                    except ValueError:
                        pass
            adopt_kw[key] = val
        cfg = CSPMConfig(max_dis=max_dis, dis_scale=dis_scale,
                         cost_method=CostMethod[cc], use_cs=use_cs,
                         use_pp=use_pp, reg_lambda=reg_lambda,
                         scale_num=scale_num, **adopt_kw)
        bads, t_engine = [], 0.0
        for seed in range(args.seeds):
            t0 = time.perf_counter()
            out = run_pair_np(pair.left, pair.right, cfg, seed=seed)
            t_engine = time.perf_counter() - t0   # last run (warm)
            bads.append(bad_pixel_rate(
                out["dis"][0].astype(np.float32) / dis_scale,
                pair.disp_left, pair.valid_left, 1.0))
        bad_e = float(np.mean(bads))
        delta = bad_e - bad_o
        # Bootstrap 95% upper confidence bound on the delta of means:
        # both sides are stochastic optimizers scored over few seeds, and
        # a +0.005-scale regression once hid inside seed noise
        # (merge_view, config.py); the bound must hold on the CI
        # upper end, not just the point estimate.
        brng = np.random.default_rng(0)
        e_s = np.asarray(bads, np.float64)
        o_s = np.asarray(bads_o, np.float64)
        n_boot = 10000
        d_bs = (brng.choice(e_s, (n_boot, e_s.size)).mean(axis=1)
                - brng.choice(o_s, (n_boot, o_s.size)).mean(axis=1))
        ci_hi = float(np.quantile(d_bs, 0.975))
        ok = ci_hi <= 0.005
        rows.append(dict(config=name, bad_oracle=round(bad_o, 4),
                         bad_engine=round(bad_e, 4),
                         delta=round(delta, 4),
                         delta_ci95_hi=round(ci_hi, 4), within_bound=ok,
                         t_oracle_s=round(t_oracle, 1),
                         t_engine_s=round(t_engine, 2)))
        print(f"{name:22s} oracle {bad_o:.4f} ({t_oracle:5.1f}s)  "
              f"engine {bad_e:.4f} ({t_engine:5.2f}s)  "
              f"delta {delta:+.4f} (ci95<={ci_hi:+.4f})  "
              f"{'OK' if ok else 'OVER'}",
              file=sys.stderr, flush=True)

    worst = max(r["delta"] for r in rows)
    worst_ci = max(r["delta_ci95_hi"] for r in rows)
    print(json.dumps({"metric": "bad_pixel_delta_vs_oracle_worst",
                      "value": round(worst, 4),
                      "worst_ci95_hi": round(worst_ci, 4), "bound": 0.005,
                      "rows": rows}))
    return 0 if worst_ci <= 0.005 else 1


if __name__ == "__main__":
    sys.exit(main())
