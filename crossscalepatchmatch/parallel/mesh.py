"""Device-mesh helpers for data-parallel + spatially-tiled execution.

The reference has no distributed execution at all (single process + two
OpenMP row loops, SURVEY.md section 2.3).  The scaling model here is a
logical (data, ty, tx) mesh that follows the algorithm alone:
  * axis "data": independent stereo pairs (batch DP) -- the analogue of the
    reference's "run the binary per pair";
  * axes "ty"/"tx": row bands and column blocks of one pair (spatial
    tiling, the stereo analogue of sequence parallelism) with halo
    exchange of images/volumes (static 17-px window halo) and plane state
    (per-sweep stencil halo) between mesh neighbors.
Both views of a pair stay on the same shard so the left-right consistency
check and view propagation never cross devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_data: int = 1, n_ty: Optional[int] = None, n_tx: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a (data, ty, tx) mesh over the available devices.

    "tx" shards image columns (2-D spatial tiling with column halo
    exchange, parallel.tiled) -- useful for wide inputs (KITTI 1242 px)
    where a row-only mesh would cap the per-pair device count at
    H / band-height.  n_tx defaults to 1 (row bands only).
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_ty is None:
        n_ty = len(devices) // (n_data * n_tx)
    n = n_data * n_ty * n_tx
    if n > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_ty}x{n_tx} needs more than "
            f"{len(devices)} devices")
    arr = np.asarray(devices[:n]).reshape(n_data, n_ty, n_tx)
    return Mesh(arr, ("data", "ty", "tx"))


def _cluster_env_detected() -> bool:
    """True when the environment advertises a multi-process cluster
    (a managed job) that jax.distributed can auto-configure from."""
    import os

    keys = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
            "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE")
    return any(os.environ.get(k) for k in keys)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> Mesh:
    """Multi-process setup: jax.distributed + a (data, ty) mesh.

    Call once per process before any other jax API.  Pass the arguments
    explicitly (or run under a cluster manager jax.distributed can
    auto-detect).  Returns a mesh whose "data" axis spans processes
    (independent stereo pairs never communicate) and whose "ty" axis spans
    each process's local devices.  Single-process runs (tests, one host)
    fall through to a local mesh with the same layout.

    Initialization failures PROPAGATE: a cluster run that cannot form its
    coordination service must error loudly, never degrade to a silent
    single-process mesh.  Only a plain single process (no explicit
    arguments, no cluster environment) skips jax.distributed entirely.
    """
    import jax

    explicit = (coordinator_address is not None
                or (num_processes or 0) > 1 or process_id is not None)
    if explicit:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    elif _cluster_env_detected():
        # Cluster environment without explicit args: endpoints must be
        # auto-detectable; errors propagate (no silent degradation).
        jax.distributed.initialize()
    n_procs = jax.process_count()
    local = len(jax.local_devices())
    # data spans processes; ty spans each process's local devices
    return make_mesh(n_data=n_procs, n_ty=local)
