"""Smoke tests for the profiling utilities."""

import jax.numpy as jnp

from crossscalepatchmatch.utils.profiling import PhaseTimer, throughput


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("a") as h:
        h.append(jnp.arange(10).sum())
    with t.phase("a") as h:
        h.append(jnp.arange(5).sum())
    with t.phase("b", sync=False):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    rep = t.report()
    assert "a" in rep and "%" in rep
    assert set(t.as_dict()) == {"a", "b"}


def test_throughput():
    m = throughput(10, 2.0, n_chips=4)
    assert m["pairs_per_s"] == 5.0
    assert m["pairs_per_s_per_chip"] == 1.25


def test_debug_utils(tmp_path):
    import numpy as np

    from crossscalepatchmatch.utils import debug

    out = {
        "abc": np.random.default_rng(0).normal(size=(2, 8, 10, 3)).astype(
            np.float32),
        "cost": np.random.default_rng(1).random((2, 8, 10)).astype(
            np.float32),
        "dis": (np.random.default_rng(2).random((2, 8, 10)) * 60).astype(
            np.uint8),
        "valid": np.ones((2, 8, 10), bool),
    }
    debug.print_array("cost", out["cost"])
    info = debug.pixel_info(out, 3, 4)
    a, b, c = info["left"]["abc"]
    assert abs(info["left"]["disparity"] - (a * 3 + b * 4 + c)) < 1e-5

    rgb = debug.disparity_to_color(out["dis"][0], 60)
    assert rgb.shape == (8, 10, 3) and rgb.dtype == np.uint8

    files = debug.save_debug_dumps(out, str(tmp_path / "dbg"))
    import os
    assert len(files) == 6 and all(os.path.exists(f) for f in files)
