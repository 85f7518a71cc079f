"""Checkpoint/resume: a killed run must resume bit-exactly."""

import numpy as np
import pytest

from crossscalepatchmatch import CSPMConfig
from crossscalepatchmatch.checkpoint import (load_state,
                                                 run_pair_resumable,
                                                 save_state)
from crossscalepatchmatch.data import make_pair


def _cfg():
    return CSPMConfig(max_dis=8, dis_scale=16, wnd_size=9, max_iter=2,
                      use_pp=True)


@pytest.mark.slow
def test_resume_is_bit_exact(tmp_path):
    pair = make_pair(h=40, w=56, max_dis=8, seed=2)
    cfg = _cfg()

    # uninterrupted checkpointed run
    p1 = str(tmp_path / "a.npz")
    full = run_pair_resumable(pair.left, pair.right, cfg, p1, seed=3)

    # "killed" run: run once (writes checkpoints), then truncate the state
    # back to after iteration 1 and resume from it
    p2 = str(tmp_path / "b.npz")
    mid = None

    import crossscalepatchmatch.checkpoint as ck
    orig = ck.save_state
    saved = {}

    def spy(path, state, iteration, cfg2, seed):
        saved[iteration] = state
        orig(path, state, iteration, cfg2, seed)

    ck.save_state = spy
    try:
        run_pair_resumable(pair.left, pair.right, cfg, p2, seed=3)
    finally:
        ck.save_state = orig
    assert set(saved) == {0, 1, 2}

    # rewind to iteration 1 and resume
    save_state(p2, saved[1], 1, cfg, 3)
    resumed = run_pair_resumable(pair.left, pair.right, cfg, p2, seed=3)

    np.testing.assert_array_equal(full["dis"], resumed["dis"])
    np.testing.assert_array_equal(full["abc"], resumed["abc"])


def test_resume_rank_exact_bit_exact(tmp_path):
    """Resume across the rank->exact adoption boundary: a checkpoint
    saved inside the rank phase holds rank-unit costs; the exact refresh
    must replay at the boundary so the resumed run is bit-exact."""
    pair = make_pair(h=40, w=56, max_dis=8, seed=2)
    cfg = CSPMConfig(max_dis=8, dis_scale=16, wnd_size=9, max_iter=3,
                     adopt_mode="rank+exact",
                     exact_iters=1)             # n_rank=2: it 0,1 rank

    p1 = str(tmp_path / "a.npz")
    full = run_pair_resumable(pair.left, pair.right, cfg, p1, seed=3)

    import crossscalepatchmatch.checkpoint as ck
    orig = ck.save_state
    saved = {}

    def spy(path, state, iteration, cfg2, seed):
        saved[iteration] = state
        orig(path, state, iteration, cfg2, seed)

    p2 = str(tmp_path / "b.npz")
    ck.save_state = spy
    try:
        run_pair_resumable(pair.left, pair.right, cfg, p2, seed=3)
    finally:
        ck.save_state = orig

    # rewind to iteration 1 (mid-rank-phase) and resume across the
    # boundary; then rewind to iteration 2 (boundary itself, rank units)
    for rewind in (1, 2):
        save_state(p2, saved[rewind], rewind, cfg, 3)
        resumed = run_pair_resumable(pair.left, pair.right, cfg, p2,
                                     seed=3)
        np.testing.assert_array_equal(full["dis"], resumed["dis"])
        np.testing.assert_array_equal(full["abc"], resumed["abc"])
        np.testing.assert_array_equal(full["cost"], resumed["cost"])


def test_stale_checkpoint_rejected(tmp_path):
    pair = make_pair(h=40, w=56, max_dis=8, seed=2)
    cfg = _cfg()
    p = str(tmp_path / "c.npz")
    run_pair_resumable(pair.left, pair.right, cfg, p, seed=3)
    # different seed -> checkpoint must be ignored
    assert load_state(p, cfg, seed=4) is None
    # different config -> ignored
    cfg2 = CSPMConfig(max_dis=8, dis_scale=16, wnd_size=11, max_iter=2)
    assert load_state(p, cfg2, seed=3) is None
    # matching -> accepted at final iteration
    st = load_state(p, cfg, seed=3)
    assert st is not None and st[1] == cfg.max_iter


@pytest.mark.slow
def test_sharded_resume_bit_exact(tmp_path):
    """Sharded checkpoint/resume on the virtual 8-device mesh: a run
    interrupted after iteration 1 and resumed from its process-local
    shard file must equal the uninterrupted run bit-for-bit."""
    import jax
    import jax.numpy as jnp
    import pytest

    from crossscalepatchmatch.checkpoint import (
        run_batch_sharded_resumable)
    from crossscalepatchmatch.parallel.mesh import make_mesh

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    # kept deliberately small: use_pp=False (sharded postprocess is
    # covered by tests/test_sharded.py) and wnd_size=9 -- this test is
    # about bit-exact resume, and the 3 sharded runs dominate suite time
    pairs = [make_pair(h=32, w=48, max_dis=8, seed=s) for s in (1, 2)]
    cfg = CSPMConfig(max_dis=8, dis_scale=16, wnd_size=9,
                     max_iter=2, use_pp=False)
    mesh = make_mesh(2, 2, 2)
    l = jnp.stack([jnp.asarray(p.left) for p in pairs])
    r = jnp.stack([jnp.asarray(p.right) for p in pairs])
    seeds = jnp.array([7, 7], jnp.int32)

    p1 = str(tmp_path / "a.ck")
    full = np.asarray(run_batch_sharded_resumable(l, r, seeds, cfg, mesh,
                                                  p1))

    # simulate a crash after iteration 1: rewind the shard file, resume
    import crossscalepatchmatch.checkpoint as ck
    p2 = str(tmp_path / "b.ck")
    saved = {}
    orig = ck._shards_to_disk

    def spy(path, arrs, iteration, cfg2, seed_fp):
        saved[iteration] = {k: [np.asarray(s.data)
                                for s in a.addressable_shards]
                            for k, a in arrs.items()}
        orig(path, arrs, iteration, cfg2, seed_fp)
        if iteration == 1:
            saved["file_at_1"] = open(path, "rb").read()

    ck._shards_to_disk = spy
    try:
        out_a = np.asarray(run_batch_sharded_resumable(l, r, seeds, cfg,
                                                       mesh, p2))
    finally:
        ck._shards_to_disk = orig
    np.testing.assert_array_equal(full, out_a)

    with open(p2 + ".proc0", "wb") as f:
        f.write(saved["file_at_1"])
    resumed = np.asarray(run_batch_sharded_resumable(l, r, seeds, cfg,
                                                     mesh, p2))
    np.testing.assert_array_equal(full, resumed)
