"""Sharding rules: parameter partition specs + activation constraints.

Parameter sharding follows the standard Megatron/GSPMD tensor-parallel
layout (SURVEY §2.7):

- attention: wq/wk/wv sharded on the output (head) dim, wo on the input;
- MLP: w_gate/w_up on the output (ffn) dim, w_down on the input;
- embeddings / lm_head sharded on the vocab dim;
- norms, connector, and other small params replicated.

Activation constraints are applied inside model code through
:func:`shard_activation`, which is a no-op outside a ``use_mesh`` context
(so single-device tests and CPU runs are untouched).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Tuple

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import current_mesh

Params = Dict[str, Any]

_suspend = threading.local()


@contextlib.contextmanager
def suspend_activation_sharding():
    """Trace-time no-op switch for :func:`shard_activation`.  Needed
    inside partially-manual shard_map bodies (parallel/pipeline.py):
    ``with_sharding_constraint`` rejects NamedShardings over a mesh whose
    manual axes it does not mention; tensor-parallel layouts inside such
    bodies propagate from the parameter shardings instead."""
    prev = getattr(_suspend, "on", False)
    _suspend.on = True
    try:
        yield
    finally:
        _suspend.on = prev


def shard_activation(x, spec: Tuple[Optional[str], ...]):
    mesh = current_mesh()
    if mesh is None or getattr(_suspend, "on", False):
        return x
    spec = spec[:x.ndim]
    # Drop axis names not present in the mesh (e.g. "model" on a 1-D mesh).
    cleaned = tuple(
        s if (s is None or (s in mesh.axis_names and mesh.shape[s] > 1))
        else None
        for s in spec
    )
    return jax.lax.with_sharding_constraint(
        x, NamedSharding(mesh, P(*cleaned)))


# ---------------------------------------------------------------------------
# Parameter partition specs
# ---------------------------------------------------------------------------

# Rules are matched against the "/"-joined param path (innermost name last);
# first match wins.  All LLM layer params have a leading scan/stack dim, so
# specs for "layers/..." paths start with None for the layer axis.
_LLM_RULES = [
    ("layers/wq", P(None, None, "model")),
    ("layers/wk", P(None, None, "model")),
    ("layers/wv", P(None, None, "model")),
    ("layers/wo", P(None, "model", None)),
    ("layers/w_gate", P(None, None, "model")),
    ("layers/w_up", P(None, None, "model")),
    ("layers/w_down", P(None, "model", None)),
    # int8-quantized leaves ({"q": [L, K, N], "s": [L, N]} per
    # ops/quant.py): q shards like its bf16 counterpart; per-out-channel
    # scales follow the out dim (replicated for in-dim-sharded wo/w_down)
    ("layers/wq/q", P(None, None, "model")),
    ("layers/wk/q", P(None, None, "model")),
    ("layers/wv/q", P(None, None, "model")),
    ("layers/wo/q", P(None, "model", None)),
    ("layers/w_gate/q", P(None, None, "model")),
    ("layers/w_up/q", P(None, None, "model")),
    ("layers/w_down/q", P(None, "model", None)),
    ("layers/wq/s", P(None, "model")),
    ("layers/wk/s", P(None, "model")),
    ("layers/wv/s", P(None, "model")),
    ("layers/wo/s", P(None, None)),
    ("layers/w_gate/s", P(None, "model")),
    ("layers/w_up/s", P(None, "model")),
    ("layers/w_down/s", P(None, None)),
    ("lm_head/q", P(None, "model")),
    ("lm_head/s", P("model",)),
    ("embed", P("model", None)),
    ("lm_head", P(None, "model")),
]

_WHISPER_RULES = [
    ("layers/attn/q/w", P(None, None, "model")),
    ("layers/attn/k/w", P(None, None, "model")),
    ("layers/attn/v/w", P(None, None, "model")),
    ("layers/attn/q/b", P(None, "model")),
    ("layers/attn/v/b", P(None, "model")),
    ("layers/attn/o/w", P(None, "model", None)),
    ("layers/self_attn/q/w", P(None, None, "model")),
    ("layers/self_attn/k/w", P(None, None, "model")),
    ("layers/self_attn/v/w", P(None, None, "model")),
    ("layers/self_attn/o/w", P(None, "model", None)),
    ("layers/cross_attn/q/w", P(None, None, "model")),
    ("layers/cross_attn/k/w", P(None, None, "model")),
    ("layers/cross_attn/v/w", P(None, None, "model")),
    ("layers/cross_attn/o/w", P(None, "model", None)),
    ("layers/fc1/w", P(None, None, "model")),
    ("layers/fc1/b", P(None, "model")),
    ("layers/fc2/w", P(None, "model", None)),
    ("embed_tokens", P("model", None)),
]


def _spec_for(path: str, rules) -> P:
    for suffix, spec in rules:
        if path.endswith(suffix):
            return spec
    return P()


def _tree_specs(tree, rules) -> Params:
    paths_and_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]

    def path_str(kp):
        parts = []
        for k in kp:
            if hasattr(k, "key"):
                parts.append(str(k.key))
            elif hasattr(k, "idx"):
                parts.append(str(k.idx))
        return "/".join(parts)

    flat = [_spec_for(path_str(kp), rules) for kp, _ in paths_and_leaves]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), flat)


def llm_partition_specs(params) -> Params:
    specs = _tree_specs(params, _LLM_RULES)
    mesh = current_mesh()
    if mesh is not None and "pipe" in mesh.axis_names \
            and mesh.shape["pipe"] > 1:
        # pipeline parallelism: the stacked layer axis [L, ...] shards
        # into contiguous stages (parallel/pipeline.py)
        from .pipeline import pipe_layer_specs
        layer_specs = pipe_layer_specs(specs["layers"])
        specs = dict(specs, layers=layer_specs)
    return specs


def whisper_partition_specs(params) -> Params:
    return _tree_specs(params, _WHISPER_RULES)


def replicated_specs(params) -> Params:
    return jax.tree.map(lambda _: P(), params)


def fsdp_partition_specs(params, axis: str = "data",
                         min_size: int = 8192) -> Params:
    """ZeRO-3-style specs for TRAINABLE params: each large leaf sharded
    over ``axis`` on its largest divisible dim; small or indivisible
    leaves stay replicated.

    With these specs on the trainable tree, GSPMD all-gathers each param
    at its point of use in the forward and reduce-scatters its gradient
    in the backward — params and grads shrink by the "data" axis size
    per chip (adafactor's factored stats are tiny; for optimizers with
    full moments, jit keeps update math on the sharded layout).  The
    largest trainable state of this model family is the 8B+ORCA f32
    cross-attention stack (9.1 GB params + 9.1 GB grads).  The reference
    is DDP-only (SURVEY §2.7: every GPU holds full params + optimizer
    state)."""
    mesh = current_mesh()
    if (mesh is None or axis not in mesh.axis_names
            or mesh.shape[axis] <= 1):
        return replicated_specs(params)
    n = mesh.shape[axis]

    def spec(x):
        if not hasattr(x, "shape") or x.size < min_size:
            return P()
        cand = [(d, i) for i, d in enumerate(x.shape) if d % n == 0]
        if not cand:
            return P()
        _, dim = max(cand)
        out = [None] * x.ndim
        out[dim] = axis
        return P(*out)

    return jax.tree.map(spec, params)


def apply_sharding(params, specs):
    """Device-put a param tree according to a spec tree (requires an active
    mesh; no-op without one)."""
    mesh = current_mesh()
    if mesh is None:
        return params
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        params, specs,
        is_leaf=lambda x: isinstance(x, P),
    )
