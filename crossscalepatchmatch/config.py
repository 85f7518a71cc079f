"""Typed configuration for the cross-scale PatchMatch stereo engine.

The reference implementation (CrossScalePatchMatch, see /root/reference) splits its
configuration between 10 runtime gflags (CSPM/main.cc:23-34) and a scatter of
compile-time constants (CSPM/main.cc:93-94,100; CSPM/plane_cost/grd_pc.h:13-17;
CSPM/cc/cen_cc.h:5-6; CSPM/cs_patchmatch.h:14,145-146; CSPM/cc/grd_cc.h:6-9).
Here every knob is promoted into one frozen dataclass so configs are
hashable (usable as jit static args) and serializable.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class CostMethod(str, enum.Enum):
    """Matching-cost (cost-volume) construction method.

    Mirrors the reference factory GetCCType (CSPM/main.cc:39-55): "GRD" is the
    truncated-absolute-difference color+gradient cost (cc/grd_cc.cpp), "CEN" is
    the 9x9/80-bit census-Hamming cost (cc/cen_cc.cc).
    """

    GRD = "GRD"
    CEN = "CEN"


class Aggregator(str, enum.Enum):
    """Optional cost-volume aggregation filter applied to each disparity slice.

    Covers the reference's ca_filter capability surface (CSPM/ca_method.h,
    CSPM/ca_filter/{BoxCA,GFCA,BFCA}.cpp).  NONE matches the compiled reference
    binary (no aggregation; the vcxproj does not build ca_filter).
    """

    NONE = "NONE"
    BOX = "BOX"
    GF = "GF"
    BF = "BF"


@dataclasses.dataclass(frozen=True)
class CSPMConfig:
    """All engine parameters.  Defaults reproduce the reference binary.

    Runtime flags of the reference (CSPM/main.cc:23-34):
      max_dis, dis_scale, cc_name->cost_method, use_cs, use_pp, reg_lambda.
    Promoted compile-time constants:
      max_iter=3, wnd_size=35 (CSPM/main.cc:93-94), scale_num=5 (main.cc:100),
      cost_alpha/tau_clr/tau_grd (cc/grd_cc.h:6-9), wgt_gamma
      (plane_cost/pre_cs_pc.h:17), census_wnd/census_bit (cc/cen_cc.h:5-6),
      wmf_gamma (cs_patchmatch.h:14), max_norm/z_stop_thres
      (cs_patchmatch.h:145-146), border_thres (cc/grd_cc.h:6).
    """

    # --- problem shape -----------------------------------------------------
    max_dis: int = 60           # max allowed disparity (inclusive range [0, max_dis])
    dis_scale: int = 4          # uint8 output rescaling factor

    # --- method selection --------------------------------------------------
    cost_method: CostMethod = CostMethod.GRD
    use_cs: bool = False        # cross-scale aggregation (5-level pyramid + lambda weights)
    use_pp: bool = False        # post-processing (LR check, fill, weighted median)
    reg_lambda: float = 0.0     # inter-scale regularization strength
    aggregator: Aggregator = Aggregator.NONE  # per-slice cost-volume filter

    # --- optimizer ---------------------------------------------------------
    max_iter: int = 3           # outer PatchMatch iterations
    wnd_size: int = 35          # support-window size (odd)
    scale_num: int = 5          # pyramid levels when use_cs
    max_norm: float = 1.0       # initial normal perturbation magnitude
    z_stop_thres: float = 0.1   # refinement stop threshold on disparity perturbation
    # Data-parallel propagation schedule: the reference's sequential raster scan
    # (cs_patchmatch.cc:163-216) is restructured into checkerboard (red-black)
    # half-sweeps where every pixel of one parity adopts the argmin plane among
    # its neighbor candidates.  `prop_sweeps` half-sweep pairs run per outer
    # iteration; `far_offsets` adds Gipuma-style long-range candidate rings
    # (4 axis-aligned samples per entry) so information still travels
    # quickly despite the shorter per-sweep horizon -- the raster scan's
    # whole-image reach per pass becomes a geometric ladder here.
    # Consecutive sweeps CYCLE through the rings (models.patchmatch._stencil)
    # so the ladder costs no extra evaluations: on the 375x450 bench scene
    # (5, 25) improved bad-pixel 0.0065 -> 0.0052 over the single ring (and
    # closes the optimizer gap vs the sequential-raster oracle on mid-size
    # scenes).
    prop_sweeps: int = 2
    far_offsets: Tuple[int, ...] = (5, 25)   # () disables far candidates
    # Batched refinement: propose all halving-schedule perturbations at once
    # and adopt the argmin (one evaluation) instead of the
    # reference's sequential refine-the-refined loop; see
    # models.patchmatch.plane_refinement.  `refine_stages` splits the
    # batched schedule into that many adopt-between groups: 1 = fully
    # batched (fastest), len(schedule) = sequential exploitation like the
    # reference (each round perturbs the updated plane), intermediate
    # values trade evaluations for exploitation.
    # Default 2: measured on 192x256 GRD, two stages tighten the bad-pixel
    # spread (0.0217-0.0230 across seeds vs 0.0217-0.0255 fully batched)
    # for one extra evaluation per iteration.
    batch_refine: bool = True
    refine_stages: int = 2
    # Candidate prescreening: rank multi-candidate batches (sweeps,
    # refinement stages) on a window subsampled by this stride and fully
    # evaluate only the winner (1 disables -- reference-faithful ranking).
    # An optimizer-search heuristic, not a cost redefinition: adoption
    # still compares full-window costs.  Single-scale precomputed path
    # only.  Default 2: on the 375x450 bench scene bad-pixel went
    # 0.0052 -> 0.0049 (the half-density window ranks candidates at least
    # as well as the full one at 1/4 the samples); stride 3 degrades small
    # windows.
    prescreen_stride: int = 2
    # Prescreen evaluator: "volume" ranks candidates on per-pair
    # precomputed ASW-weighted quadrant volumes (ops.prescreen_volume) --
    # four tent lerps per pixel per candidate instead of hundreds of
    # window samples; "window" samples the strided window per candidate.
    # Default "volume": on the 375x450 d60 GRD bench scene bad-pixel went
    # 0.0049 -> 0.0034 -- the quadrant ranking is a BETTER ranker than the
    # strided window (exact for locally fronto-parallel windows,
    # slant-aware through the four anchor disparities) at four lerps per
    # candidate instead of hundreds of window samples.
    # prescreen_stride doubles as the build's window subsampling.  Used
    # by the single-device and spatially-sharded paths (cross-scale runs
    # have no prescreen either way).
    prescreen_mode: str = "volume"
    # Adoption metric: "exact" compares full-window costs for every
    # adoption decision (reference-faithful, cs_patchmatch.cc:201,209);
    # "rank" adopts directly on the quadrant-volume ranking costs (no
    # exact evaluations inside the optimizer -- the cheapest schedule);
    # "rank+exact" runs all but the last outer iteration in rank mode,
    # refreshes the state cost exactly, and runs the final iteration
    # with exact adoption (recovers exact-mode sub-pixel refinement at a
    # fraction of the launches).  "rank"/"rank+exact" require the
    # quadrant prescreen (prescreen_mode="volume", prescreen_stride>1,
    # precompute_volume).
    adopt_mode: str = "rank+exact"
    # Trailing exact iterations in "rank+exact" mode (the first
    # max_iter - exact_iters iterations adopt on ranking costs).  More
    # exact iterations = closer to reference parity, fewer = faster.
    # Measured on the 8-config eval matrix against the CPU oracle:
    # exact_iters=1 breaks the 0.005 bad-pixel bound on the
    # occlusion-stress scene (+0.0083); exact_iters=2 passes every row
    # at <= +0.0018 -- tighter than all-exact adoption's worst row
    # (+0.0023; the rank phase's full-window quadrant ranking appears to
    # act as a mild regularizer) -- while cutting exact full-window
    # launches ~1/3.  Hence rank+exact/2 is the production default;
    # adopt_mode="exact" remains the reference-faithful schedule.
    exact_iters: int = 2
    # Fold the view-propagation candidate into the last spatial sweep's
    # candidate batch (one K=2 exact evaluation instead of two K=1
    # evaluations per iteration).  The merged
    # view candidate is gathered from the state BEFORE the last sweep's
    # spatial adoption (the reference gathers after,
    # cs_patchmatch.cc:61-99).  Default OFF: the parity matrix caught it
    # degrading quality past the 0.005 bound on three rows (readme_demo
    # +0.0067, occlusions +0.0057, lowtex +0.0051 at 5 seeds); with the
    # standalone view-propagation evaluation every row is <= +0.0021.
    # The pre-adoption gather weakens the
    # view exchange exactly where propagation matters most (plain GRD,
    # occlusion- and texture-stressed scenes).
    merge_view: bool = False

    # Compute the adaptive-support weights on the CIE Lab conversion of
    # each (pyramid-level) image instead of raw BGR -- the reference's
    # USE_LAB_WGT variant (grd_pc.h:25, weight L1 over u8 Lab channels
    # grd_pc.cc:80-110, per-level conversions cspc.cc:48-49).  Compiled
    # OFF in the reference; exposed here as a capability.  The data term
    # and post-processing stay BGR/gradient either way (the weighted
    # median's LUT is BGR even under the reference's toggle).  Supported
    # on every path: the precomputed-volume paths (jnp and kernel) and the
    # literal jnp on-the-fly path.
    use_lab_weights: bool = False

    # --- cost model constants ---------------------------------------------
    cost_alpha: float = 0.1     # color/gradient mixing weight
    tau_clr: float = 10.0       # color truncation
    tau_grd: float = 2.0        # gradient truncation
    border_thres: float = 3.0   # pseudo-intensity for out-of-border GRD cost
    wgt_gamma: float = 10.0     # adaptive-support-weight color bandwidth
    census_wnd: int = 9         # census window (odd)
    wmf_gamma: float = 10.0     # weighted-median color bandwidth

    # --- post-processing ---------------------------------------------------
    lr_check_thres: float = 0.5  # max |d_l - d_r| for a pixel to be valid

    # --- plane-cost backend --------------------------------------------------
    # True: precomputed cost volumes (PreSSPC/PreCSPC, the reference main()'s
    # only path, main.cc:97-114).  False: on-the-fly TAD color+gradient
    # against the sub-pixel warped other view (GrdPC/CSPC capability
    # surface -- in the reference these classes are compiled but unreachable
    # from main()); requires cost_method=GRD.  The on-the-fly path is the
    # literal jnp implementation (ops.onthefly_cost) on every backend;
    # production runs use the precomputed path.
    precompute_volume: bool = True

    # --- numerics / runtime ------------------------------------------------
    seed: int = 0
    eps: float = 1e-8           # kDoubleEps analogue (commfunc.h:25)
    # Window cost on the fused GPU kernel (ops.pallas.window_cost); False
    # runs the jnp form on the GPU too.  The CPU always runs jnp
    # (backend.cost_backend).
    use_pallas: bool = True
    # Storage dtype of the kernel-layout cost volumes ("f32" | "bf16"):
    # the kernel reads the volume in this dtype and accumulates in f32,
    # so only the stored slice values round -- census costs (integers
    # 0-80) are exact in bf16, GRD costs round at ~0.4% relative.  bf16
    # halves the kernel layout's device memory.  The jnp path always
    # reads f32.  See PERF.md for the measured speed of each.
    vol_dtype: str = "f32"

    def __post_init__(self):
        if self.wnd_size % 2 != 1:
            raise ValueError(f"wnd_size must be odd, got {self.wnd_size}")
        if self.census_wnd % 2 != 1:
            raise ValueError(f"census_wnd must be odd, got {self.census_wnd}")
        if self.max_dis < 1:
            raise ValueError(f"max_dis must be >= 1, got {self.max_dis}")
        if not self.precompute_volume and self.cost_method != CostMethod.GRD:
            raise ValueError(
                "the on-the-fly plane cost exists only for GRD "
                "(grd_pc.cc/cspc.cc have no census variant)")
        if not self.precompute_volume and self.aggregator != Aggregator.NONE:
            raise ValueError(
                "aggregation filters need a precomputed volume to filter "
                "(ca_method.h operates on volume slices)")
        if self.vol_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"vol_dtype must be 'f32' or 'bf16', got "
                f"{self.vol_dtype!r}")
        if self.prescreen_mode not in ("window", "volume"):
            raise ValueError(
                f"prescreen_mode must be 'window' or 'volume', got "
                f"{self.prescreen_mode!r}")
        if self.adopt_mode not in ("exact", "rank", "rank+exact"):
            raise ValueError(
                f"adopt_mode must be 'exact', 'rank' or 'rank+exact', "
                f"got {self.adopt_mode!r}")
        if self.adopt_mode == "rank" and not self.rank_enabled:
            raise ValueError(
                "rank adoption requires the quadrant-volume prescreen "
                "(prescreen_mode='volume', prescreen_stride>1, "
                "precompute_volume=True)")
        if not 1 <= self.exact_iters:
            raise ValueError(
                f"exact_iters must be >= 1, got {self.exact_iters}")

    @property
    def rank_enabled(self) -> bool:
        """Rank adoption is only defined over the quadrant-volume
        ranking (the measured schedule); configs without it -- e.g. the
        no-volume fly path -- run "rank+exact" as all-exact."""
        return (self.adopt_mode != "exact"
                and self.prescreen_mode == "volume"
                and self.prescreen_stride > 1 and self.precompute_volume)

    @property
    def rank_iters(self) -> int:
        """Leading optimizer iterations that adopt on ranking costs."""
        if not self.rank_enabled:
            return 0
        if self.adopt_mode == "rank":
            return self.max_iter
        return max(0, self.max_iter - self.exact_iters)

    @property
    def half_wnd(self) -> int:
        return self.wnd_size // 2

    @property
    def census_bit(self) -> int:
        return self.census_wnd * self.census_wnd - 1

    @property
    def num_slices(self) -> int:
        """Cost-volume slices: d in [0, max_dis] inclusive (pre_ss_pc.cc:40-42)."""
        return self.max_dis + 1

    def scale_max_dis(self, scale: int) -> int:
        """Per-pyramid-level max disparity: halved per level (pre_cs_pc.cc:48)."""
        d = self.max_dis
        for _ in range(scale):
            d //= 2
        return d

    def scale_shape(self, hw: Tuple[int, int], scale: int) -> Tuple[int, int]:
        """Per-level image shape: ceil-halved per level (pre_cs_pc.cc:46-47)."""
        h, w = hw
        for _ in range(scale):
            h, w = (h + 1) // 2, (w + 1) // 2
        return h, w

    def refinement_schedule(self) -> Tuple[float, ...]:
        """Halving disparity-perturbation magnitudes z: max_dis/2, /4, ...

        Mirrors the while(z >= z_stop) loop of cs_patchmatch.cc:292-345 --
        the count is static given max_dis so the loop unrolls under jit.
        """
        out = []
        z = self.max_dis / 2.0
        while z >= self.z_stop_thres:
            out.append(z)
            z /= 2.0
        return tuple(out)


# Canonical workload configs from the reference's input.txt and README
# (CSPM/input.txt:1-20, README.md:12-14).
README_DEMO = CSPMConfig(max_dis=60, dis_scale=4, cost_method=CostMethod.GRD,
                         use_cs=False, use_pp=False, reg_lambda=0.0)

# KITTI-style high-resolution workload (1242x375, 128 disparities, scored at
# the 3-px threshold).  The reference never ran KITTI but its BFCA carries a
# "change BF window size for KITTI" note (ca_filter/BFCA.cpp:9-11); this
# preset is the engine's high-res configuration.
KITTI = CSPMConfig(max_dis=128, dis_scale=1, cost_method=CostMethod.GRD,
                   use_pp=True)

MIDDLEBURY = {
    "tsukuba": CSPMConfig(max_dis=16, dis_scale=16, cost_method=CostMethod.CEN,
                          use_pp=True),
    "venus": CSPMConfig(max_dis=20, dis_scale=8, cost_method=CostMethod.CEN,
                        use_pp=True),
    "cones": CSPMConfig(max_dis=60, dis_scale=4, cost_method=CostMethod.CEN,
                        use_pp=True),
    "teddy": CSPMConfig(max_dis=60, dis_scale=4, cost_method=CostMethod.CEN,
                        use_pp=True),
    "reindeer": CSPMConfig(max_dis=80, dis_scale=3, cost_method=CostMethod.CEN,
                           use_pp=True),
}
