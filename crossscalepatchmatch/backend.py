"""Runtime choices made once per process or per config: which plane-cost
backend evaluates the window cost, and where compiled programs are cached.
"""

from __future__ import annotations

import os

import jax

from .config import CSPMConfig

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cost_backend(cfg: CSPMConfig, platform: str | None = None) -> str:
    """The window-cost backend for `cfg` on `platform` (default: JAX's).

    Returns "pallas" (the fused GPU kernel, ops.pallas.window_cost) or
    "jnp" (the plain XLA form, ops.plane_cost):
      * gpu with cfg.use_pallas: "pallas";
      * gpu with use_pallas=False: "jnp" -- the only way onto the jnp path
        on a GPU is to ask for it;
      * cpu: "jnp".  The jnp path is the authority the CPU tests check;
        the kernel is tested there by calling it in interpret mode.
    Any other platform raises: nothing else has been built or checked.
    """
    platform = jax.default_backend() if platform is None else platform
    if platform == "gpu":
        return "pallas" if cfg.use_pallas else "jnp"
    if platform == "cpu":
        return "jnp"
    raise RuntimeError(
        f"no plane-cost backend for platform {platform!r} (gpu and cpu "
        f"are supported)")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    JAX_COMPILATION_CACHE_DIR, when set, is the directory and no other is
    set; otherwise the cache lives in <repo>/.jax_cache.  Call before the
    first compile.

    Source locations are kept to one frame: a Pallas kernel is embedded in
    the program with its locations, and with full tracebacks those name
    the caller's stack, so the CLI, the benches and the smoke test would
    each miss the others' entries for the same program.
    """
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".jax_cache"))
    jax.config.update("jax_include_full_tracebacks_in_locations", False)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
