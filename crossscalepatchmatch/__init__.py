"""crossscalepatchmatch: data-parallel cross-scale PatchMatch stereo engine.

A from-scratch JAX/XLA/Pallas re-design of the CrossScalePatchMatch
reference (PatchMatch stereo with slanted support windows, Bleyer et al.
BMVC'11, + cross-scale cost aggregation, Zhang et al. CVPR'14): dense
checkerboard plane propagation, fused window-cost kernels, pjit/shard_map
spatial tiling for multi-chip scale.
"""

from .config import Aggregator, CostMethod, CSPMConfig, MIDDLEBURY, README_DEMO

__version__ = "0.1.0"

__all__ = [
    "Aggregator",
    "CostMethod",
    "CSPMConfig",
    "MIDDLEBURY",
    "README_DEMO",
]
