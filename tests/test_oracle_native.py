"""Cross-checks between the native C++ oracle (csrc/) and the JAX engine.

The oracle implements the reference's *sequential* semantics; the engine is
the restructured optimizer.  Cost volumes must agree exactly (same
deterministic math); end-to-end disparity maps must agree within the
stochastic-optimizer tolerance on the synthetic scene.
"""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest

from crossscalepatchmatch import CSPMConfig, CostMethod
from crossscalepatchmatch import oracle
from crossscalepatchmatch.data import make_pair
from crossscalepatchmatch.metrics import bad_pixel_rate
from crossscalepatchmatch.models.pipeline import run_pair_np
from crossscalepatchmatch.ops.cost_volume import build_volume
from crossscalepatchmatch.ops.color import bgr_to_rgb

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++")


@pytest.fixture(scope="module")
def pair():
    return make_pair(h=64, w=96, max_dis=12, seed=11)


@pytest.mark.parametrize("cc", ["GRD", "CEN"])
@pytest.mark.parametrize("right", [False, True])
def test_cost_volume_agreement(pair, cc, right):
    want = oracle.cost_volume(pair.left, pair.right, max_dis=12, cc_name=cc,
                              right=right)                 # [D+1, H, W]
    cfg = CSPMConfig(max_dis=12, dis_scale=16,
                     cost_method=CostMethod[cc])
    got = build_volume(bgr_to_rgb(jnp.asarray(pair.left)),
                       bgr_to_rgb(jnp.asarray(pair.right)), 12, cfg,
                       right=right)                        # [H, W, D+1]
    got = np.moveaxis(np.asarray(got, np.float64), -1, 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)  # engine is f32


def test_end_to_end_vs_oracle(pair):
    """Engine and oracle must solve the same scene to similar quality."""
    cfg = CSPMConfig(max_dis=12, dis_scale=16, wnd_size=15,
                     cost_method=CostMethod.GRD, use_pp=True)
    ours = run_pair_np(pair.left, pair.right, cfg, seed=0)
    oracle_dis = oracle.run_pair(pair.left, pair.right, max_dis=12,
                                 dis_scale=16, cc_name="GRD", use_pp=True,
                                 wnd_size=15, seed=0)
    ours_d = ours["dis"][0].astype(np.float32) / 16.0
    orc_d = oracle_dis[0].astype(np.float32) / 16.0
    bad_ours = bad_pixel_rate(ours_d, pair.disp_left, pair.valid_left)
    bad_orc = bad_pixel_rate(orc_d, pair.disp_left, pair.valid_left)
    # the restructuring must not degrade quality beyond the baseline bound
    # (BASELINE.json: <= 0.5% bad-pixel delta).
    assert bad_ours <= bad_orc + 0.005, (bad_ours, bad_orc)
    # and both must actually solve the synthetic scene
    assert bad_orc < 0.15, bad_orc
