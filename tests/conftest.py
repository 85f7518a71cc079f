"""Test harness: run everything on a virtual 8-device CPU mesh.

Must set platform flags before jax is imported anywhere.  The CPU is the
test authority (backend.cost_backend): the GPU kernel is tested here in
the Pallas interpreter, and compiled on the card by chip_smoke.py.
"""

import os

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
import sys

sys.path.insert(0, _REPO)

import jax

# the tests run on the CPU even on a machine with a GPU
jax.config.update("jax_platforms", "cpu")

# Persistent compile cache: XLA-CPU compiles of the unrolled window/census
# graphs take tens of seconds; cache them across test runs.
from crossscalepatchmatch.backend import enable_compile_cache

enable_compile_cache()
