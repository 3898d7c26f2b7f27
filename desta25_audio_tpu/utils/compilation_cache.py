"""Persistent-compilation-cache setup shared by the test harness, the
CLI entrypoints, and benchmarks.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says, and otherwise
at the fixed ``<repo>/.jax_cache``.  Two rules:

- Accelerator entries live in the cache root itself.
- CPU entries are AOT-compiled for the build host's exact CPU features
  and the cache key does NOT include them: loading another host's entry
  warns "could lead to execution errors such as SIGILL" and can silently
  miscompute.  CPU caches are therefore keyed into a per-feature-set
  subdirectory, so a host swap starts a fresh cache instead of loading
  poisonous entries.
"""

from __future__ import annotations

import hashlib
import os

DEFAULT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cpu_feature_tag() -> str:
    """Stable tag for this host's CPU identity + the XLA version.

    Hashing only the cpuinfo ``flags`` line proved too weak: two VM
    hosts with identical flags but different CPU MODELS got the same
    tag, and XLA:CPU AOT entries carry LLVM *tuning* features derived
    from the model (e.g. ``+prefer-no-scatter``) — loading them on the
    other host logs "could lead to execution errors such as SIGILL".
    Include the model/family/stepping lines and the jax/jaxlib versions
    (AOT format changes across releases)."""
    keep = ("vendor_id", "cpu family", "model", "stepping", "flags")
    try:
        with open("/proc/cpuinfo") as f:
            first_cpu = f.read().split("\n\n")[0]
        ident = "\n".join(ln for ln in first_cpu.splitlines()
                          if ln.split("\t")[0].strip() in keep
                          or ln.split(":")[0].strip() in keep)
    except OSError:
        ident = ""
    import jax
    import jaxlib
    ident += f"|jax={jax.__version__}|jaxlib={jaxlib.__version__}"
    return "cpu-" + hashlib.sha1(ident.encode()).hexdigest()[:12]


def setup_compilation_cache(root: str | None = None,
                            cache_everything: bool = False) -> str:
    """Point JAX's persistent compilation cache at ``root`` (default:
    repo-level ``.jax_cache``, or ``$JAX_COMPILATION_CACHE_DIR``), keyed
    into a CPU-feature subdirectory when the backend resolves to CPU.

    Call AFTER the platform choice is final (``jax.config`` platform
    updates, ``JAX_PLATFORMS``) and before the first compile.  With
    ``cache_everything`` the minimum-compile-time/entry-size thresholds
    drop to zero — worth it for test suites that re-run many ~0.2 s CPU
    programs, not for production (inflates the cache with trivia).
    Returns the directory used."""
    import jax

    if root is None:
        root = os.environ.get("JAX_COMPILATION_CACHE_DIR", DEFAULT_ROOT)
    if jax.default_backend() == "cpu":
        root = os.path.join(root, cpu_feature_tag())
    jax.config.update("jax_compilation_cache_dir", root)
    if cache_everything:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return root
