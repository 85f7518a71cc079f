"""Command-line driver: flag-compatible with the reference binary.

The reference CLI (CSPM/main.cc:23-34) exposes ten gflags flags; this
driver accepts the same names/semantics plus the promoted compile-time
constants (max_iter/wnd_size/scale_num, main.cc:93-100) and engine knobs.

Example (the reference README demo, README.md:12-14):
    python -m crossscalepatchmatch \
        --l_img_file cones/im2.png --r_img_file cones/im6.png \
        --l_dis_file l_dis.png --r_dis_file r_dis.png \
        --max_dis 60 --dis_scale 4 --cc_name GRD \
        --use_cs false --use_pp false --reg_lambda 0.0
"""

from __future__ import annotations

import argparse
import sys
import time


def _bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="crossscalepatchmatch",
        description="cross-scale PatchMatch stereo")
    # the reference's ten flags (main.cc:23-34); required unless
    # --input_list supplies them per line
    p.add_argument("--l_img_file", help="left view PNG")
    p.add_argument("--r_img_file", help="right view PNG")
    p.add_argument("--l_dis_file", help="output left disparity PNG")
    p.add_argument("--r_dis_file", help="output right disparity PNG")
    p.add_argument("--max_dis", type=int, default=60)
    p.add_argument("--dis_scale", type=int, default=4)
    p.add_argument("--cc_name", choices=["GRD", "CEN"], default="GRD")
    p.add_argument("--use_cs", type=_bool, default=False,
                   help="cross-scale cost aggregation")
    p.add_argument("--use_pp", type=_bool, default=False,
                   help="post-processing (LR check/fill/weighted median)")
    p.add_argument("--reg_lambda", type=float, default=0.0)
    # promoted compile-time constants (main.cc:93-100)
    p.add_argument("--max_iter", type=int, default=3)
    p.add_argument("--wnd_size", type=int, default=35)
    p.add_argument("--scale_num", type=int, default=5)
    # engine knobs
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--aggregator", choices=["NONE", "BOX", "GF", "BF"],
                   default="NONE", help="per-slice cost-volume filter")
    p.add_argument("--use_pallas", type=_bool, default=True,
                   help="window cost on the fused GPU kernel; false runs "
                        "the jnp form (the CPU always does)")
    p.add_argument("--prescreen_stride", type=int, default=2,
                   help="window subsample stride for candidate ranking "
                        "(1 disables prescreening)")
    p.add_argument("--prescreen_mode", choices=["window", "volume"],
                   default="volume",
                   help="candidate ranking: strided window samples or "
                        "precomputed ASW quadrant volumes (the production "
                        "default, config.CSPMConfig.prescreen_mode)")
    p.add_argument("--adopt_mode", choices=["exact", "rank", "rank+exact"],
                   default="rank+exact",
                   help="adoption metric schedule; 'exact' is the "
                        "reference-faithful schedule")
    p.add_argument("--exact_iters", type=int, default=2,
                   help="final exact iterations under adopt_mode="
                        "rank+exact")
    p.add_argument("--merge_view", type=_bool, default=False,
                   help="fold the view-propagation candidate into the "
                        "last spatial sweep's evaluation (one launch "
                        "fewer per iteration; degrades parity on "
                        "propagation-critical scenes, see config)")
    p.add_argument("--precompute_volume", type=_bool, default=True,
                   help="false = on-the-fly GRD cost (GrdPC/CSPC, no cost "
                        "volume)")
    p.add_argument("--use_lab_weights", type=_bool, default=False,
                   help="compute ASW weights on the CIE Lab conversion "
                        "(the reference's USE_LAB_WGT variant, "
                        "grd_pc.h:25 -- compiled off there)")
    p.add_argument("--input_list", default=None,
                   help="file of flag lines (the reference's input.txt "
                        "format); runs every line in one process so "
                        "same-config runs share the compile cache")
    p.add_argument("--oracle", action="store_true",
                   help="run the native CPU oracle instead of the engine")
    p.add_argument("--profile_dir", default=None,
                   help="write a jax profiler trace here")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .backend import enable_compile_cache
    enable_compile_cache()
    if args.input_list:
        # batch mode: one line = one run (the reference's input.txt,
        # CSPM/input.txt:1-20).  Same-config lines share the jit cache,
        # so only the first pays the compile.
        import shlex
        parser = build_parser()
        rc = 0
        try:
            fh = open(args.input_list)
        except OSError as e:
            print(f"error: cannot read --input_list: {e}", file=sys.stderr)
            return 1
        with fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                toks = shlex.split(line)
                if toks and not toks[0].startswith("-"):
                    toks = toks[1:]          # leading binary name
                rc |= _run_one(parser.parse_args(toks))
        return rc
    return _run_one(args)


def _run_one(args) -> int:
    from . import io as cspm_io

    for f in ("l_img_file", "r_img_file", "l_dis_file", "r_dis_file"):
        if getattr(args, f) is None:
            print(f"error: --{f} is required", file=sys.stderr)
            return 1

    l_bgr = cspm_io.read_bgr(args.l_img_file)
    r_bgr = cspm_io.read_bgr(args.r_img_file)
    if l_bgr.shape != r_bgr.shape:
        print(f"error: view shapes differ: {l_bgr.shape} vs {r_bgr.shape}",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    if args.oracle:
        from . import oracle
        dis = oracle.run_pair(
            l_bgr, r_bgr, max_dis=args.max_dis, dis_scale=args.dis_scale,
            cc_name=args.cc_name, use_cs=args.use_cs, use_pp=args.use_pp,
            reg_lambda=args.reg_lambda, max_iter=args.max_iter,
            wnd_size=args.wnd_size, scale_num=args.scale_num,
            seed=args.seed)
    else:
        from .config import Aggregator, CostMethod, CSPMConfig
        from .models.pipeline import run_pair_np

        cfg = CSPMConfig(
            max_dis=args.max_dis, dis_scale=args.dis_scale,
            cost_method=CostMethod[args.cc_name], use_cs=args.use_cs,
            use_pp=args.use_pp, reg_lambda=args.reg_lambda,
            max_iter=args.max_iter, wnd_size=args.wnd_size,
            scale_num=args.scale_num, aggregator=Aggregator[args.aggregator],
            use_pallas=args.use_pallas,
            prescreen_stride=args.prescreen_stride,
            prescreen_mode=args.prescreen_mode,
            adopt_mode=args.adopt_mode, exact_iters=args.exact_iters,
            merge_view=args.merge_view,
            precompute_volume=args.precompute_volume,
            use_lab_weights=args.use_lab_weights)
        if args.profile_dir:
            import jax
            with jax.profiler.trace(args.profile_dir):
                out = run_pair_np(l_bgr, r_bgr, cfg, seed=args.seed)
        else:
            out = run_pair_np(l_bgr, r_bgr, cfg, seed=args.seed)
        dis = out["dis"]
    dt = time.perf_counter() - t0
    print(f"Total Time: {dt:.3f} s")   # same final printout as main.cc:125

    cspm_io.write_gray(args.l_dis_file, dis[0])
    cspm_io.write_gray(args.r_dis_file, dis[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
