"""Benchmark: stereo pairs/s on one GPU on the reference's canonical workload.

Workload: cones-sized pair (375x450), max_dis=60, GRD cost, 35x35 window,
plain PatchMatch (the reference README demo config, README.md:12-14).

Prints the device (platform, device_kind, count) and the card's name and
power limit, then ONE JSON line: {"metric", "value", "unit",
"vs_baseline", "device", ...}.  Fails when JAX finds no GPU.

vs_baseline compares against the reference algorithm's measured single-pair
CPU wall clock for this workload.  The upstream repository publishes no
numbers, so the baseline is this repo's own from-scratch C++ oracle
(csrc/cspm_oracle.cc, g++ -O3 -march=native -fopenmp), which reproduces the
reference's sequential semantics: 282.1 s/pair, bad-pixel(nonocc) 0.004 on
the synthetic cones-sized scene, on one core of the CPU host it was built
on.  Re-measure with `python bench.py --measure-baseline`.
"""

import json
import subprocess
import sys
import time

# Reference CPU baseline: seconds per pair on the canonical workload,
# measured from csrc/cspm_oracle.cc (see module docstring).
BASELINE_CPU_SECONDS_PER_PAIR = 282.1
BASELINE_SOURCE = "measured-oracle"


def measure_baseline():
    """Re-measure the CPU oracle on the canonical workload (minutes)."""
    import numpy as np

    from crossscalepatchmatch import oracle
    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.metrics import bad_pixel_rate

    pair = make_pair(h=375, w=450, max_dis=60, seed=0)
    t0 = time.perf_counter()
    out = oracle.run_pair(pair.left, pair.right, max_dis=60, dis_scale=4,
                          cc_name="GRD", use_cs=False, use_pp=False, seed=0)
    dt = time.perf_counter() - t0
    bad = bad_pixel_rate(np.asarray(out[0], np.float32) / 4.0,
                         pair.disp_left, pair.valid_left)
    print(f"oracle: {dt:.1f} s/pair, bad-pixel(nonocc) {bad:.3f}")
    print("update BASELINE_CPU_SECONDS_PER_PAIR accordingly")


def main():
    if "--measure-baseline" in sys.argv:
        measure_baseline()
        return
    batch = 0
    if "--batch" in sys.argv:
        batch = int(sys.argv[sys.argv.index("--batch") + 1])
    import jax

    from crossscalepatchmatch.backend import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {dev.platform}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(f"bench: device {device}; card {card}", flush=True)

    import jax.numpy as jnp
    import numpy as np

    from crossscalepatchmatch import CSPMConfig, CostMethod
    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.metrics import bad_pixel_rate
    from crossscalepatchmatch.models.pipeline import run_pair

    h, w, max_dis = 375, 450, 60
    cfg = CSPMConfig(max_dis=max_dis, dis_scale=4,
                     cost_method=CostMethod.GRD, use_cs=False, use_pp=False)
    pair = make_pair(h=h, w=w, max_dis=max_dis, seed=0)
    l = jnp.asarray(pair.left)
    r = jnp.asarray(pair.right)

    # compile + warmup
    t0 = time.perf_counter()
    out = jax.block_until_ready(run_pair(l, r, jnp.int32(0), cfg))
    t_compile = time.perf_counter() - t0

    # accuracy sanity on the synthetic scene
    disp = np.asarray(out["dis"][0], np.float32) / cfg.dis_scale
    bad = bad_pixel_rate(disp, pair.disp_left, pair.valid_left, 1.0)
    print(f"bench: {h}x{w} max_dis={max_dis} wnd={cfg.wnd_size}: "
          f"compile+first-run {t_compile:.1f}s, bad-pixel(nonocc) {bad:.4f}",
          flush=True)

    iters = 5
    t0 = time.perf_counter()
    for i in range(1, iters + 1):
        jax.block_until_ready(run_pair(l, r, jnp.int32(i), cfg))
    dt = (time.perf_counter() - t0) / iters
    pairs_per_s = 1.0 / dt
    print(f"bench: {dt*1e3:.1f} ms/pair", flush=True)

    if batch > 1:
        # single-device batch serving (models.pipeline.run_pairs): B pairs
        # per dispatch
        from crossscalepatchmatch.models.pipeline import run_pairs
        ls = jnp.broadcast_to(l, (batch,) + l.shape)
        rs = jnp.broadcast_to(r, (batch,) + r.shape)
        seeds = jnp.arange(batch, dtype=jnp.int32)
        jax.block_until_ready(run_pairs(ls, rs, seeds, cfg))
        t0 = time.perf_counter()
        for i in range(1, iters + 1):
            jax.block_until_ready(run_pairs(ls, rs, seeds + batch * i, cfg))
        dtb = (time.perf_counter() - t0) / iters
        print(f"bench: batch={batch}: {dtb*1e3:.1f} ms/batch = "
              f"{dtb/batch*1e3:.1f} ms/pair ({batch/dtb:.3f} pairs/s)",
              flush=True)

    print(json.dumps({
        "metric": "stereo_pairs_per_second",
        "value": round(pairs_per_s, 4),
        "unit": f"pairs/s (375x450, max_dis=60, GRD, vs {BASELINE_SOURCE} "
                f"CPU baseline {BASELINE_CPU_SECONDS_PER_PAIR:.0f}s/pair)",
        "vs_baseline": round(pairs_per_s * BASELINE_CPU_SECONDS_PER_PAIR, 2),
        "bad_pixel_nonocc": round(bad, 4),
        "device": device,
        "card": card,
    }))


if __name__ == "__main__":
    main()
