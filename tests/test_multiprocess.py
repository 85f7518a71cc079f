"""Real multi-process distributed execution (VERDICT round-1 item 3).

Spawns two OS processes that form a jax.distributed cluster (explicit
coordinator, CPU backend, 4 virtual devices each -> 8 global devices),
run the sharded pipeline over a (data=2, ty=4) mesh whose "data" axis
spans the processes, and assert the multi-process result equals the
single-process run of the identical program on 8 local virtual devices.

This exercises what the single-process 8-device tests cannot: cross-host
coordination-service setup (parallel.mesh.initialize_multihost), global
arrays assembled from process-local shards, and collectives running over
a mesh with non-addressable devices.
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from crossscalepatchmatch.backend import enable_compile_cache
enable_compile_cache()

pid = int(sys.argv[1])
from crossscalepatchmatch.parallel.mesh import initialize_multihost
mesh = initialize_multihost(coordinator_address={coord!r},
                            num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
# initialize_multihost lays out data=n_hosts x ty=local: (2, 4, 1)
assert dict(mesh.shape) == {{"data": 2, "ty": 4, "tx": 1}}, mesh.shape


import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from crossscalepatchmatch import CSPMConfig, CostMethod
from crossscalepatchmatch.data import make_pair
from crossscalepatchmatch.parallel.tiled import jit_run_batch_sharded

cfg = CSPMConfig(max_dis=8, dis_scale=16, wnd_size=11,
                 cost_method=CostMethod.GRD, use_cs=False, use_pp=False,
                 max_iter=2)
pairs = [make_pair(h=32, w=48, max_dis=8, seed=s) for s in (1, 2)]
l_np = np.stack([p.left for p in pairs])
r_np = np.stack([p.right for p in pairs])
seeds_np = np.array([0, 0], np.int32)

def make_global(x_np, spec):
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        x_np.shape, sharding, lambda idx: jnp.asarray(x_np[idx]))

l = make_global(l_np, P("data", "ty"))
r = make_global(r_np, P("data", "ty"))
seeds = make_global(seeds_np, P("data"))

# Compile ahead of time, then rendezvous on the COORDINATOR barrier
# (configurable timeout, no collectives) before executing: the compile
# can take minutes on this host's single core and a persistent-cache hit
# on one side skews the processes far past Gloo's fixed 30 s
# context-init deadline at the first collective (observed flake: "Gloo
# context initialization failed: DEADLINE_EXCEEDED").  After the
# barrier both processes reach the first collective within
# milliseconds, so the Gloo rendezvous cannot time out.
compiled = jit_run_batch_sharded(cfg, mesh).lower(l, r, seeds).compile()
# wait_at_barrier is a private jax._src API (verified against the jax
# pinned in this image, 2026-08); if a jax upgrade moves it, fall back to
# executing directly -- re-accepting the Gloo context-init flake rather
# than failing the suite on an attribute error.
from jax._src import distributed
_client = getattr(distributed.global_state, "client", None)
if _client is not None and hasattr(_client, "wait_at_barrier"):
    _client.wait_at_barrier("precompile", 600_000)
out = compiled(l, r, seeds)
jax.block_until_ready(out)
shards = [([sl.indices(dim) for sl, dim in zip(s.index, out.shape)],
           np.asarray(s.data)) for s in out.addressable_shards]
with open({out_tmpl!r}.format(pid), "wb") as f:
    pickle.dump({{"shape": out.shape, "shards": shards}}, f)
print("worker", pid, "ok", flush=True)
"""


@pytest.mark.slow
@pytest.mark.skipif(sys.platform != "linux", reason="linux only")
def test_two_process_matches_single_process(tmp_path):
    # free port for the coordination service
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    out_tmpl = str(tmp_path / "worker{}.pkl")
    script = _WORKER.format(repo=_REPO, coord=coord, out_tmpl=out_tmpl)
    script_path = tmp_path / "worker.py"
    script_path.write_text(script)

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen([sys.executable, str(script_path), str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for i in range(2)]
    outs = [p.communicate(timeout=900)[0].decode() for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{o[-4000:]}"

    # assemble the global result from both workers' addressable shards
    full = None
    for i in range(2):
        with open(out_tmpl.format(i), "rb") as f:
            d = pickle.load(f)
        if full is None:
            full = np.zeros(d["shape"], np.uint8)
        for idxs, data in d["shards"]:
            full[tuple(slice(*t) for t in idxs)] = data

    # single-process reference: identical program on 8 local devices
    import jax
    import jax.numpy as jnp
    from crossscalepatchmatch import CSPMConfig, CostMethod
    from crossscalepatchmatch.data import make_pair
    from crossscalepatchmatch.parallel.mesh import make_mesh
    from crossscalepatchmatch.parallel.tiled import jit_run_batch_sharded

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices for the reference run")
    cfg = CSPMConfig(max_dis=8, dis_scale=16, wnd_size=11,
                     cost_method=CostMethod.GRD, use_cs=False, use_pp=False,
                     max_iter=2)
    pairs = [make_pair(h=32, w=48, max_dis=8, seed=s) for s in (1, 2)]
    l = jnp.stack([jnp.asarray(p.left) for p in pairs])
    r = jnp.stack([jnp.asarray(p.right) for p in pairs])
    ref = np.asarray(jit_run_batch_sharded(cfg, make_mesh(2, 4))(
        l, r, jnp.array([0, 0], jnp.int32)))

    np.testing.assert_array_equal(full, ref)
