"""Fast random parameter initialization for benchmarks / dry runs.

Proper per-layer initializers build an unrolled graph with hundreds of
random ops (32 distinct layers x ~10 leaves), which is slow to compile
and wasteful when the weights only need plausible magnitudes (perf
benchmarks, compile checks, smoke runs).  ``random_tree_like`` uses
``jax.eval_shape`` on the real init to get the exact tree structure, then
fills every leaf with one normal draw — a ~N-op program for N leaves —
except normalization scales, which start at one as in the real init.
The draws come from XLA's RngBitGenerator (an "rbg" key), whose program
compiles in seconds where threefry over gigabytes of weights takes
minutes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def random_tree_like(key, init_fn, scale: float = 0.02):
    """init_fn: key -> param tree (never executed; only shape-evaluated)."""
    shapes = jax.eval_shape(init_fn, key)
    paths_leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = [leaf for _, leaf in paths_leaves]
    is_scale = [bool(path) and getattr(path[-1], "key", None) == "scale"
                for path, _ in paths_leaves]
    seed = jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max)

    @jax.jit
    def build(seed):
        base = jax.random.key(seed, impl="rbg")
        out = []
        for i, leaf in enumerate(leaves):
            k = jax.random.fold_in(base, i)
            if is_scale[i]:
                x = jnp.ones(leaf.shape, leaf.dtype)
            elif jnp.issubdtype(leaf.dtype, jnp.floating):
                x = (jax.random.normal(k, leaf.shape, leaf.dtype)
                     * jnp.asarray(scale, leaf.dtype))
            elif leaf.dtype == jnp.int8:
                x = jax.random.randint(k, leaf.shape, -127, 128,
                                       jnp.int32).astype(jnp.int8)
            else:
                x = jnp.zeros(leaf.shape, leaf.dtype)
            out.append(x)
        return jax.tree_util.tree_unflatten(treedef, out)

    return build(seed)
