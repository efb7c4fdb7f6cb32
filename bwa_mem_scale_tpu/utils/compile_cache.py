"""Persistent XLA compilation cache (the warm-binary analogue of the
reference's shm-resident index: pay the multi-minute compile once per
program shape, stream it back on every later run).

Enabled by bench.py, chip_smoke.py, the CLI and the test suite. Where
JAX_COMPILATION_CACHE_DIR is set, JAX keeps the cache there and this
module sets no directory; otherwise the cache is <checkout>/.jax_cache.
Opt out with BWATPU_NO_COMPILE_CACHE=1 (e.g. when timing cold compiles
on purpose).
"""

import os

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache():
    if os.environ.get("BWATPU_NO_COMPILE_CACHE"):
        return
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
