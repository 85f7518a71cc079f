"""Smoke test of the stereo engine on a GPU, through the entry points a user
calls, at real widths.

    python chip_smoke.py               # one card: phases 1-4
    python chip_smoke.py --four-cards  # four cards: the sharded phase only
    python chip_smoke.py --tiny        # rehearsal at toy shapes, any device

Phases (one card):
  1. device: jax.devices(), the JAX version, the card's name and power limit;
  2. the fused window-cost kernel, compiled for the card, against the jnp
     authority at 375x450 d60: K in {1, 8} with f32 and bf16 volumes,
     5-level cross-scale, and a sharded-band ([ylo, yhi) bounds) case;
  3. run_pair end to end on three configurations, kernel against the jnp
     path on the same card, scene and seed (bad-pixel parity bound 0.005);
  4. serving forms: run_pairs (B=4), one run_pair_warm frame, then the
     CLI on PNG files.
With --four-cards: run_batch_sharded on a (4,1,1) mesh with four pairs and
on a (1,2,2) mesh with one wide pair, each against one-card runs.

Every failure raises; the last line of stdout is one JSON object
{"ok": true, "device": {...}} only when every phase passed on a GPU.  The
script itself stays off JAX: the engine phases run in one child process and
the CLI in another after it, so one process holds the card at a time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
PARITY = 0.005          # bad-pixel parity bound (PARITY.md)
REL_TOL = 1e-4          # kernel vs reference: max|diff| <= REL_TOL*max|ref|
ARGMIN_AGREE = 0.9999   # share of pixels whose argmin over K agrees
MISMATCH = 0.001        # share of u8 pixels allowed to differ


def _geom(tiny: bool):
    """(h, w, max_dis) of the bench scene and of the wide scene."""
    if tiny:
        return (48, 64, 12), (48, 96, 16)
    return (375, 450, 60), (375, 1242, 128)


def _configs(tiny: bool):
    from crossscalepatchmatch import CostMethod, CSPMConfig

    (h, w, md), (hk, wk, mdk) = _geom(tiny)
    small = dict(wnd_size=9, scale_num=3) if tiny else {}
    demo = CSPMConfig(max_dis=md, dis_scale=4, cost_method=CostMethod.GRD,
                      **small)
    cs = CSPMConfig(max_dis=md, dis_scale=4, cost_method=CostMethod.CEN,
                    use_cs=True, reg_lambda=0.3, use_pp=True,
                    **({"scale_num": 5} if not tiny else small))
    kitti = CSPMConfig(max_dis=mdk, dis_scale=1, cost_method=CostMethod.GRD,
                       use_pp=True, **small)
    return [("readme_demo", demo, h, w), ("cen_cs5_pp", cs, h, w),
            ("kitti_grd_pp", kitti, hk, wk)]


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def _bad(dis_u8, dis_scale, pair) -> float:
    import numpy as np

    from crossscalepatchmatch.metrics import bad_pixel_rate
    return float(bad_pixel_rate(np.asarray(dis_u8, np.float32) / dis_scale,
                                pair.disp_left, pair.valid_left, 1.0))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _precompile(jobs) -> None:
    """Compile (jitted fn, *args) jobs concurrently, ahead of their calls.

    One XLA compile runs mostly on one host core; the pipeline programs
    take minutes each on a GPU host, so they are compiled side by side in
    threads.  The executables land in the persistent compile cache
    (backend.enable_compile_cache), where the calls that follow find them.
    """
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(lambda j: j[0].lower(*j[1:]).compile(), jobs))
    print(f"  compiled {len(jobs)} programs side by side in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _sds(shape, dtype):
    import jax
    return jax.ShapeDtypeStruct(shape, dtype)


def _planes(key, k, h, w, d):
    """Candidate planes like the optimizer's: half near-fronto in a narrow
    band, half wild over the whole volume."""
    import jax
    import jax.numpy as jnp

    ka, kd, kb = jax.random.split(key, 3)
    spread = jnp.where(jnp.arange(k) % 2 == 0, 0.05, 1.0)[:, None, None,
                                                           None]
    ab = jax.random.uniform(ka, (2, k, h, w, 2), jnp.float32, -1, 1)
    ab = ab * spread[None]
    dc = jax.random.uniform(kd, (2, k, h, w), jnp.float32, 0, d)
    xs = jnp.arange(w, dtype=jnp.float32)
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    c = dc - ab[..., 0] * xs - ab[..., 1] * ys
    return jnp.concatenate([ab, c[..., None]], axis=-1)


def _compare(name, got, want) -> None:
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    _check(got.shape == want.shape and np.isfinite(got).all(),
           f"{name}: shape {got.shape} vs {want.shape} or non-finite")
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    agree = float(np.mean(np.argmin(got, axis=1) == np.argmin(want, axis=1)))
    print(f"  {name}: max|diff|/max|ref| {rel:.3e} (bound {REL_TOL:g}), "
          f"argmin agreement {agree:.6f} (bound {ARGMIN_AGREE})",
          flush=True)
    _check(rel <= REL_TOL, f"{name}: relative error {rel:.3e}")
    _check(agree >= ARGMIN_AGREE, f"{name}: argmin agreement {agree}")


def phase_kernel(tiny: bool) -> None:
    """Phase 2: the compiled kernel against the jnp authority."""
    import jax
    import jax.numpy as jnp

    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.models import patchmatch as pm
    from crossscalepatchmatch.ops.cost_volume import VolumeData
    from crossscalepatchmatch.ops.cost_volume import build_volume_data
    from crossscalepatchmatch.ops.pallas import window_cost as wc
    from crossscalepatchmatch.ops.plane_cost import window_plane_cost

    print("phase 2: window-cost kernel vs jnp reference", flush=True)
    # off the card (a --tiny rehearsal) the kernel runs in the interpreter
    interpret = jax.default_backend() != "gpu"
    (_, demo, h, w), (_, cs, _, _) = _configs(tiny)[:2]
    md = demo.max_dis
    pair = make_pair(h=h, w=w, max_dis=md, seed=0)
    l, r = jnp.asarray(pair.left), jnp.asarray(pair.right)
    with jax.default_matmul_precision("highest"):
        vd = jax.jit(build_volume_data, static_argnums=2)(l, r, demo)
        vd_bf = VolumeData(vd.imgs, [v.astype(jnp.bfloat16).astype(
            jnp.float32) for v in vd.vols], vd.max_costs)
        for k in (1, 8):
            abc = _planes(jax.random.PRNGKey(k), k, h, w, md)
            for dtype, vref in (("f32", vd), ("bf16", vd_bf)):
                cfg = dataclasses.replace(demo, vol_dtype=dtype)
                got = jax.jit(pm._kernel_cost_fns(cfg, vd, interpret)[0])(
                    abc)
                want = jax.jit(pm._jnp_cost_fns(cfg, vref)[0])(abc)
                _compare(f"{h}x{w} d{md} wnd{demo.wnd_size} K={k} {dtype}",
                         got, want)

        vd_cs = jax.jit(build_volume_data, static_argnums=2)(l, r, cs)
        abc = _planes(jax.random.PRNGKey(2), 2, h, w, md)
        got = jax.jit(pm._kernel_cost_fns(cs, vd_cs, interpret)[0])(abc)
        want = jax.jit(pm._jnp_cost_fns(cs, vd_cs)[0])(abc)
        _compare(f"cross-scale {cs.scale_num} levels K=2", got, want)

        # a sharded band: rows [r0, h) with real halo rows above and
        # past-the-border rows below, against the full image's rows
        hb, r0 = demo.half_wnd, h // 2
        imgs, vols, mc = vd.weight_imgs[0], vd.vols[0], vd.max_costs[0]
        # planes on a 2^-10 grid: the re-anchoring c + b*r0 and every
        # plane evaluation are then exact in f32, so the band must
        # reproduce the full image's rows up to the kernel's own rounding
        abc = jnp.round(_planes(jax.random.PRNGKey(3), 2, h, w, md)
                        * 1024.0) / 1024.0
        want = jax.jit(jax.vmap(lambda i, v, m, a: window_plane_cost(
            i, v, m, a, half_wnd=hb, max_dis=md, gamma=demo.wgt_gamma)))(
                imgs, vols, mc, abc)[:, :, r0:]

        def band(x):
            pad = jnp.zeros((2, hb) + x.shape[2:], x.dtype)
            return jnp.concatenate([x[:, r0 - hb:], pad], axis=1)

        abc_b = abc[:, :, r0:].at[..., 2].add(abc[:, :, r0:, :, 1] * r0)
        bounds = jnp.array([hb - r0, hb + h - r0, 0, w], jnp.int32)
        got = jax.jit(lambda p, a: wc.window_cost_prepared(
            p, mc, a, half_wnd=hb, max_dis=md, gamma=demo.wgt_gamma,
            origin=(hb, 0), bounds=bounds, interpret=interpret))(
                wc.prepare(band(imgs), band(vols)), abc_b)
        _compare(f"ybounds band rows [{r0}, {h})", got, want)


def phase_pipeline(tiny: bool) -> dict:
    """Phase 3: run_pair with the kernel against the jnp path."""
    import jax.numpy as jnp
    import numpy as np

    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.models.pipeline import (run_pair,
                                                      run_pair_warm,
                                                      run_pairs)

    print("phase 3: run_pair, kernel vs jnp path (seconds per pair are "
          "bring-up readings, not a benchmark)", flush=True)
    u8, i32 = jnp.uint8, jnp.int32
    jobs = []
    for _, cfg, h, w in _configs(tiny):
        img = _sds((h, w, 3), u8)
        for c in (cfg, dataclasses.replace(cfg, use_pallas=False)):
            jobs.append((run_pair, img, img, _sds((), i32), c))
    _, demo, h, w = _configs(tiny)[0]
    imgs = _sds((4, h, w, 3), u8)
    jobs.append((run_pairs, imgs, imgs, _sds((4,), i32), demo))
    img = _sds((h, w, 3), u8)
    jobs.append((run_pair_warm, img, img, _sds((), i32),
                 _sds((2, h, w, 3), jnp.float32), demo))
    _precompile(jobs)
    demo_out = {}
    for name, cfg, h, w in _configs(tiny):
        pair = make_pair(h=h, w=w, max_dis=cfg.max_dis, seed=0)
        l, r = jnp.asarray(pair.left), jnp.asarray(pair.right)
        out, t_first = _timed(run_pair, l, r, jnp.int32(0), cfg)
        bad_k = _bad(out["dis"][0], cfg.dis_scale, pair)
        times = [_timed(run_pair, l, r, jnp.int32(s), cfg)[1]
                 for s in (1, 2, 3)]
        cfg_j = dataclasses.replace(cfg, use_pallas=False)
        out_j, t_j = _timed(run_pair, l, r, jnp.int32(0), cfg_j)
        bad_j = _bad(out_j["dis"][0], cfg.dis_scale, pair)
        same = float(np.mean(np.asarray(out["dis"])
                             == np.asarray(out_j["dis"])))
        print(f"  {name} {h}x{w} d{cfg.max_dis}: kernel "
              f"{np.median(times):.4f} s/pair (median of 3 after warm-up; "
              f"first call {t_first:.1f} s incl. compile), jnp path first "
              f"call {t_j:.1f} s incl. compile; bad-pixel(nonocc, 1px) "
              f"kernel {bad_k:.4f} jnp {bad_j:.4f} "
              f"|diff| {abs(bad_k - bad_j):.4f} (bound {PARITY}); "
              f"identical u8 share {same:.4f}", flush=True)
        _check(np.isfinite(np.asarray(out["cost"])).all(),
               f"{name}: non-finite costs")
        _check(abs(bad_k - bad_j) <= PARITY, f"{name}: parity")
        if name == "readme_demo":
            demo_out = dict(cfg=cfg, pair=pair, out=out, bad=bad_k)
    return demo_out


def phase_serving(workdir: str, demo: dict) -> None:
    """Phase 4 (in-process part): run_pairs and run_pair_warm; writes the
    CLI's inputs."""
    import jax.numpy as jnp
    import numpy as np

    from crossscalepatchmatch import io as cspm_io
    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.models.pipeline import run_pair_warm, run_pairs

    print("phase 4: serving forms", flush=True)
    cfg, pair, out = demo["cfg"], demo["pair"], demo["out"]
    h, w, _ = pair.left.shape
    pairs = [pair] + [make_pair(h=h, w=w, max_dis=cfg.max_dis, seed=s)
                      for s in (1, 2, 3)]
    ls = jnp.stack([jnp.asarray(p.left) for p in pairs])
    rs = jnp.stack([jnp.asarray(p.right) for p in pairs])
    seeds = jnp.arange(4, dtype=jnp.int32)
    _timed(run_pairs, ls, rs, seeds, cfg)
    outb, t = _timed(run_pairs, ls, rs, seeds, cfg)
    bads = [_bad(outb["dis"][b, 0], cfg.dis_scale, p)
            for b, p in enumerate(pairs)]
    print(f"  run_pairs B=4: {t / 4:.4f} s/pair; bad-pixel "
          f"{[round(b, 4) for b in bads]}", flush=True)
    _check(abs(bads[0] - demo["bad"]) <= PARITY, "run_pairs parity")
    _check(max(bads) < 0.1, "run_pairs bad-pixel")

    l, r = jnp.asarray(pair.left), jnp.asarray(pair.right)
    _timed(run_pair_warm, l, r, jnp.int32(1), out["abc"], cfg)
    warm, t = _timed(run_pair_warm, l, r, jnp.int32(1), out["abc"], cfg)
    bad_w = _bad(warm["dis"][0], cfg.dis_scale, pair)
    print(f"  run_pair_warm: {t:.4f} s/frame; bad-pixel {bad_w:.4f} "
          f"(cold {demo['bad']:.4f})", flush=True)
    _check(bad_w <= demo["bad"] + PARITY, "warm frame parity")

    cspm_io.write_bgr(os.path.join(workdir, "l.png"), pair.left)
    cspm_io.write_bgr(os.path.join(workdir, "r.png"), pair.right)
    np.savez(os.path.join(workdir, "expect.npz"),
             dis=np.asarray(out["dis"][0]), gt=pair.disp_left,
             valid=pair.valid_left, bad=demo["bad"],
             dis_scale=cfg.dis_scale, max_dis=cfg.max_dis,
             wnd_size=cfg.wnd_size, scale_num=cfg.scale_num)


def phase_four_cards(tiny: bool) -> None:
    """Phase 5: run_batch_sharded across four cards against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.models.pipeline import run_pair
    from crossscalepatchmatch.parallel.mesh import make_mesh
    from crossscalepatchmatch.parallel.tiled import jit_run_batch_sharded

    devs = jax.devices()
    _check(len(devs) >= 4, f"--four-cards needs 4 devices, found {devs}")
    (_, demo, h, w), _, (_, kitti, hk, wk) = _configs(tiny)
    print("phase 5: run_batch_sharded on four cards", flush=True)
    # ty x tx tiling needs H % 2 == 0: one extra row (KITTI frames come as
    # 375 or 376 rows)
    hk += hk % 2
    fn4 = jit_run_batch_sharded(demo, make_mesh(4, 1, 1, devices=devs[:4]))
    fn1 = jit_run_batch_sharded(demo, make_mesh(1, 1, 1, devices=devs[:1]))
    mesh = make_mesh(1, 2, 2, devices=devs[:4])
    fn = jit_run_batch_sharded(kitti, mesh)
    fn_j = jit_run_batch_sharded(
        dataclasses.replace(kitti, use_pallas=False), mesh)
    u8, i32 = jnp.uint8, jnp.int32
    _precompile([
        (fn4, _sds((4, h, w, 3), u8), _sds((4, h, w, 3), u8),
         _sds((4,), i32)),
        (fn1, _sds((1, h, w, 3), u8), _sds((1, h, w, 3), u8),
         _sds((1,), i32)),
        (run_pair, _sds((h, w, 3), u8), _sds((h, w, 3), u8), _sds((), i32),
         demo),
        (fn, _sds((1, hk, wk, 3), u8), _sds((1, hk, wk, 3), u8),
         _sds((1,), i32)),
        (fn_j, _sds((1, hk, wk, 3), u8), _sds((1, hk, wk, 3), u8),
         _sds((1,), i32)),
        (run_pair, _sds((hk, wk, 3), u8), _sds((hk, wk, 3), u8),
         _sds((), i32), kitti)])

    pairs = [make_pair(h=h, w=w, max_dis=demo.max_dis, seed=s)
             for s in range(4)]
    ls = jnp.stack([jnp.asarray(p.left) for p in pairs])
    rs = jnp.stack([jnp.asarray(p.right) for p in pairs])
    seeds = jnp.arange(4, dtype=i32)
    fn4(ls, rs, seeds)
    dis4, t4 = _timed(fn4, ls, rs, seeds)
    # every pair on a (1,1,1) mesh of card 0 runs the same per-pair program
    # with the same key, so the maps must agree
    dis1 = np.concatenate([np.asarray(fn1(ls[b:b + 1], rs[b:b + 1],
                                          seeds[b:b + 1])) for b in range(4)])
    diff = float(np.mean(np.asarray(dis4) != dis1))
    bads = []
    for b, p in enumerate(pairs):
        ref = run_pair(ls[b], rs[b], seeds[b], demo)
        bads.append((_bad(dis4[b, 0], demo.dis_scale, p),
                     _bad(ref["dis"][0], demo.dis_scale, p)))
    # the sharded path draws its own random streams, so against run_pair
    # the parity bound holds on the mean over the pairs
    mean_s, mean_r = (float(np.mean(x)) for x in zip(*bads))
    print(f"  (4,1,1) {h}x{w} d{demo.max_dis}, 4 pairs: {t4:.4f} s/batch; "
          f"u8 mismatch vs one card {diff:.6f} (bound {MISMATCH}); "
          f"mean bad-pixel sharded {mean_s:.4f} run_pair {mean_r:.4f} "
          f"(bound {PARITY})", flush=True)
    _check(diff <= MISMATCH, "(4,1,1) vs one-card maps")
    _check(abs(mean_s - mean_r) <= PARITY, "(4,1,1) parity")

    # Tiles draw their own random streams, so the maps differ from
    # run_pair's; the tiles' kernel maps are compared with the jnp form on
    # the same mesh (same random streams) and, by bad-pixel, with run_pair
    p = make_pair(h=hk, w=wk, max_dis=kitti.max_dis, seed=5)
    l, r = jnp.asarray(p.left)[None], jnp.asarray(p.right)[None]
    dis, _ = _timed(fn, l, r, seeds[:1])
    dis1, t = _timed(fn, l, r, seeds[1:2])
    dis_j = fn_j(l, r, seeds[:1])
    diff = float(np.mean(np.asarray(dis) != np.asarray(dis_j)))
    bad_s = float(np.mean([_bad(d[0, 0], kitti.dis_scale, p)
                           for d in (dis, dis1)]))
    bad_r = float(np.mean([_bad(run_pair(l[0], r[0], s, kitti)["dis"][0],
                                kitti.dis_scale, p) for s in seeds[:2]]))
    print(f"  (1,2,2) {hk}x{wk} d{kitti.max_dis} GRD+PP: {t:.4f} s/pair; "
          f"u8 mismatch kernel vs jnp on the mesh {diff:.6f} (bound "
          f"{MISMATCH}); bad-pixel over 2 seeds sharded {bad_s:.4f} "
          f"run_pair {bad_r:.4f} (bound {PARITY})", flush=True)
    _check(diff <= MISMATCH, "(1,2,2) kernel vs jnp maps")
    _check(abs(bad_s - bad_r) <= PARITY, "(1,2,2) parity")


def engine(args) -> int:
    """The child process: every phase that runs on JAX."""
    sys.path.insert(0, _REPO)
    import jax

    from crossscalepatchmatch.backend import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    print(f"phase 1: devices {devs}, jax {jax.__version__}", flush=True)
    if devs[0].platform != "gpu" and not args.tiny:
        print(f"chip_smoke: no GPU (platform {devs[0].platform})",
              file=sys.stderr)
        return 1
    if devs[0].platform == "gpu":
        print(_nvidia_smi(), flush=True)
    t0 = time.perf_counter()

    def done(phase):
        print(f"  phase {phase} done at t+{time.perf_counter() - t0:.0f} s "
              f"(compiles included)", flush=True)

    if args.four_cards:
        phase_four_cards(args.tiny)
        done(5)
    else:
        phase_kernel(args.tiny)
        done(2)
        demo = phase_pipeline(args.tiny)
        done(3)
        phase_serving(args.workdir, demo)
        done(4)
    with open(os.path.join(args.workdir, "device.json"), "w") as f:
        json.dump({"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)}, f)
    return 0


def cli_phase(workdir: str) -> None:
    """Phase 4, CLI part: `python -m crossscalepatchmatch` on the PNGs."""
    sys.path.insert(0, _REPO)
    import numpy as np

    from crossscalepatchmatch import io as cspm_io
    from crossscalepatchmatch.metrics import bad_pixel_rate

    exp = np.load(os.path.join(workdir, "expect.npz"))
    out_l = os.path.join(workdir, "l_dis.png")
    cmd = [sys.executable, "-m", "crossscalepatchmatch",
           "--l_img_file", os.path.join(workdir, "l.png"),
           "--r_img_file", os.path.join(workdir, "r.png"),
           "--l_dis_file", out_l,
           "--r_dis_file", os.path.join(workdir, "r_dis.png"),
           "--max_dis", str(int(exp["max_dis"])),
           "--dis_scale", str(int(exp["dis_scale"])), "--cc_name", "GRD",
           "--wnd_size", str(int(exp["wnd_size"])),
           "--scale_num", str(int(exp["scale_num"])), "--seed", "0"]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, cwd=_REPO, timeout=600)
    dis = cspm_io.read_gray(out_l)
    bad = float(bad_pixel_rate(dis.astype(np.float32) / exp["dis_scale"],
                               exp["gt"], exp["valid"], 1.0))
    same = float(np.mean(dis == exp["dis"]))
    print(f"  CLI: {time.perf_counter() - t0:.1f} s incl. start-up and "
          f"compile; bad-pixel {bad:.4f} (run_pair {float(exp['bad']):.4f},"
          f" bound {PARITY}); identical u8 share {same:.4f}", flush=True)
    _check(abs(bad - float(exp["bad"])) <= PARITY, "CLI parity")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--tiny", action="store_true",
                    help="rehearse at toy shapes on any device; prints no "
                         "result line")
    ap.add_argument("--engine", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--workdir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.engine:
        return engine(args)

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cmd = [sys.executable, os.path.abspath(__file__), "--engine",
               "--workdir", workdir]
        cmd += ["--four-cards"] * args.four_cards + ["--tiny"] * args.tiny
        rc = subprocess.run(cmd, timeout=1100).returncode
        if rc != 0:
            print(f"chip_smoke: engine phases failed (exit {rc})",
                  file=sys.stderr)
            return rc
        if not args.four_cards:
            cli_phase(workdir)
        with open(os.path.join(workdir, "device.json")) as f:
            device = json.load(f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.tiny:
        print(f"chip_smoke: rehearsal passed on {device}")
        return 0
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
