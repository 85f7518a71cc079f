"""Device timings of the window-cost evaluators and the pipeline on a GPU.

Measures, on one card, at 375x450 d60 and 375x1242 d128 (real GRD volumes
of data.make_pair scenes):
  * one exact window-cost evaluation (wnd 35, K in {1, 8}): the fused
    kernel with f32 and bf16 volumes against XLA's compilation of
    ops.plane_cost.window_plane_cost vmapped over views;
  * the quadrant-volume build (ops.prescreen_volume, plain jnp);
  * run_pair end to end with the kernel (f32, bf16 volumes) and with the
    jnp path (use_pallas=False), in turns jnp, kernel, kernel, jnp;
  * optionally (--trace DIR) a profiler trace of one kernel run_pair at
    375x450, reduced to device time per operation name.
Every time is the median of --reps runs after a warm-up, from the host
clock around work that ends in block_until_ready.

    python tools/gpu_timings.py [--reps 10] [--json OUT] [--trace DIR]
"""

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_s(fn, reps):
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def eval_timings(h, w, md, reps):
    import jax
    import jax.numpy as jnp

    from crossscalepatchmatch import CSPMConfig
    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.models import patchmatch as pm
    from crossscalepatchmatch.ops.cost_volume import build_volume_data
    from crossscalepatchmatch.ops.prescreen_volume import (
        build_quadrant_volumes)

    cfg = CSPMConfig(max_dis=md, dis_scale=1)
    pair = make_pair(h=h, w=w, max_dis=md, seed=0)
    vd = jax.jit(build_volume_data, static_argnums=2)(
        jnp.asarray(pair.left), jnp.asarray(pair.right), cfg)
    rows = {}
    for k in (1, 8):
        key = jax.random.PRNGKey(k)
        ab = jax.random.uniform(key, (2, k, h, w, 2), jnp.float32, -0.3, 0.3)
        dc = jax.random.uniform(key, (2, k, h, w), jnp.float32, 0, md)
        xs = jnp.arange(w, dtype=jnp.float32)
        ys = jnp.arange(h, dtype=jnp.float32)[:, None]
        abc = jnp.concatenate(
            [ab, (dc - ab[..., 0] * xs - ab[..., 1] * ys)[..., None]], -1)
        xla = jax.jit(pm._jnp_cost_fns(cfg, vd)[0])
        rows[f"K{k}_xla_ms"] = 1e3 * _median_s(lambda: xla(abc), reps)
        for dt in ("f32", "bf16"):
            c = dataclasses.replace(cfg, vol_dtype=dt)
            ker = jax.jit(pm._kernel_cost_fns(c, vd)[0])
            rows[f"K{k}_kernel_{dt}_ms"] = 1e3 * _median_s(
                lambda: ker(abc), reps)
    build = jax.jit(jax.vmap(functools.partial(
        build_quadrant_volumes, half_wnd=cfg.half_wnd, gamma=cfg.wgt_gamma,
        stride=cfg.prescreen_stride)))
    rows["quadrant_build_xla_ms"] = 1e3 * _median_s(
        lambda: build(vd.weight_imgs[0], vd.vols[0]), reps)
    return rows


def pipeline_timings(name, cfg, h, w, reps):
    import jax
    import jax.numpy as jnp

    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.metrics import bad_pixel_rate
    from crossscalepatchmatch.models.pipeline import run_pair

    import numpy as np

    pair = make_pair(h=h, w=w, max_dis=cfg.max_dis, seed=0)
    l, r = jnp.asarray(pair.left), jnp.asarray(pair.right)
    variants = {"jnp": dataclasses.replace(cfg, use_pallas=False),
                "kernel_f32": dataclasses.replace(cfg, vol_dtype="f32"),
                "kernel_bf16": dataclasses.replace(cfg, vol_dtype="bf16")}
    rows = {}
    for v, c in variants.items():        # compile and score each once
        t0 = time.perf_counter()
        out = run_pair(l, r, jnp.int32(0), c)
        dis = np.asarray(out["dis"][0], np.float32) / c.dis_scale
        rows[f"{v}_first_call_s"] = time.perf_counter() - t0
        rows[f"{v}_bad"] = float(bad_pixel_rate(
            dis, pair.disp_left, pair.valid_left, 1.0))
    times = {v: [] for v in variants}
    order = ["jnp", "kernel_f32", "kernel_bf16",
             "kernel_bf16", "kernel_f32", "jnp"]
    for i in range(max(1, reps // 4)):
        for v in order:
            t0 = time.perf_counter()
            jax.block_until_ready(run_pair(l, r, jnp.int32(i + 1),
                                           variants[v]))
            times[v].append(time.perf_counter() - t0)
    for v, ts in times.items():
        rows[f"{v}_s_per_pair"] = float(np.median(ts))
    return rows


def trace_breakdown(cfg, h, w, trace_dir):
    """Device time per operation name in one kernel run_pair."""
    import glob

    import jax
    import jax.numpy as jnp

    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.models.pipeline import run_pair

    pair = make_pair(h=h, w=w, max_dis=cfg.max_dis, seed=0)
    l, r = jnp.asarray(pair.left), jnp.asarray(pair.right)
    jax.block_until_ready(run_pair(l, r, jnp.int32(0), cfg))
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        jax.block_until_ready(run_pair(l, r, jnp.int32(1), cfg))
        wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    per_name, spans = {}, []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                per_name[ev.name] = per_name.get(ev.name, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:25]
    return {"wall_s_traced": wall, "device_busy_s": busy * 1e-9,
            "top_ops_ms": [(n[:90], v * 1e-6) for n, v in top]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", default=None, help="write the results here")
    ap.add_argument("--trace", default=None,
                    help="profiler trace directory for the breakdown")
    args = ap.parse_args()

    import jax

    from crossscalepatchmatch.config import KITTI, README_DEMO
    from crossscalepatchmatch.backend import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"gpu_timings: needs a GPU, found {dev.platform}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    res = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}, "card": card}
    print(card, flush=True)
    for h, w, md in ((375, 450, 60), (375, 1242, 128)):
        rows = eval_timings(h, w, md, args.reps)
        res[f"eval_{h}x{w}_d{md}"] = rows
        print(f"eval {h}x{w} d{md}: {json.dumps(rows)}", flush=True)
    for name, cfg, h, w in (("readme_demo", README_DEMO, 375, 450),
                            ("kitti_grd_pp", KITTI, 375, 1242)):
        rows = pipeline_timings(name, cfg, h, w, args.reps)
        res[f"run_pair_{name}"] = rows
        print(f"run_pair {name}: {json.dumps(rows)}", flush=True)
    if args.trace:
        for name, cfg, h, w in (("readme_demo", README_DEMO, 375, 450),
                                ("kitti_grd_pp", KITTI, 375, 1242)):
            rows = trace_breakdown(cfg, h, w,
                                   os.path.join(args.trace, name))
            res[f"trace_{name}"] = rows
            print(f"trace {name}: {json.dumps(rows)}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
