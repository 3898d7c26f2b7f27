"""Pipeline parallelism (GPipe fill-drain) for the decoder layer stack.

A third mesh axis ``"pipe"`` shards the stacked layer parameters
``[L, ...]`` into P contiguous stages (L/P layers per device).  The
training forward runs under a PARTIALLY-MANUAL ``jax.shard_map``:
``axis_names={"pipe"}`` makes only the pipeline axis manual — "data"
(batch) and "model" (tensor parallel) stay GSPMD-auto, so the existing
param shardings and activation constraints keep working inside each
stage, and dp x tp x pp compose without hand-written collectives for
the first two.

Schedule: the global batch splits into M microbatches; each of the
M + P - 1 ticks ppermutes the previous tick's stage output one hop down
the pipe and runs the local layer scan on it (stage 0 ingests microbatch
``t`` instead).  Bubble ticks compute on clamped garbage microbatches —
the standard GPipe fill/drain cost of (P-1)/(M+P-1) — and the last
stage's outputs are collected from the scan's stacked ys and
psum-broadcast over "pipe" (one stage holds real data, the rest zeros),
so every stage returns the identical full-batch hidden and the loss /
backward need no special-casing.  ``jax.grad`` differentiates straight
through the schedule (ppermute transposes to the reverse permutation —
the backward pipeline runs automatically), and per-tick ``jax.checkpoint``
keeps stage activation memory at one boundary tensor per tick.

The reference has no pipeline (or any model) parallelism — each GPU
holds the whole model (SURVEY §2.7); this exists for towers whose
training state cannot fit one card.

Semantics are pinned on the 8-device virtual CPU mesh
(tests/test_pipeline.py) and ``__graft_entry__.dryrun_multichip``
compiles the dp x pp train step.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .mesh import current_mesh

__all__ = ["pipeline_enabled", "pipeline_decoder_hidden",
           "pipe_layer_specs"]


def pipeline_enabled() -> bool:
    mesh = current_mesh()
    return (mesh is not None and "pipe" in mesh.axis_names
            and mesh.shape["pipe"] > 1)


def pipe_layer_specs(specs):
    """Prefix every ``layers/*`` partition spec's leading (stacked-layer)
    axis with "pipe".  ``specs`` is the spec tree from
    ``llm_partition_specs``; leaves are PartitionSpecs."""

    def add_pipe(spec):
        rest = tuple(spec)[1:] if len(spec) else ()
        return P("pipe", *rest)

    return jax.tree.map(add_pipe, specs,
                        is_leaf=lambda x: isinstance(x, P))


def pipeline_decoder_hidden(layers, cfg, x, kv_mask, cos, sin,
                            *, n_micro: int, remat: bool = True,
                            w8a8: bool = False):
    """Run the decoder layer stack pipelined over the "pipe" mesh axis.

    layers: stacked layer params [L, ...], leading axis sharded P("pipe").
    x: [B, T, D] embeddings; kv_mask [B, T] 1/0 key mask;
    cos/sin: RoPE tables [B, T, ...].  Returns the pre-final-norm hidden
    [B, T, D], identical on every pipe stage.

    Training path only: no KV cache, no LoRA, no extra_layer_fn (the
    ORCA deep-injection train step keeps the single-stage scan; its
    towers fit under tp).
    """
    from ..models.llm import _attention, _mlp, rms_norm

    mesh = current_mesh()
    n_pipe = mesh.shape["pipe"]
    B, T, D = x.shape
    M = int(n_micro)
    if B % M:
        raise ValueError(f"batch {B} not divisible by n_micro {M}")
    Bm = B // M

    def micro(a):
        return a.reshape(M, Bm, *a.shape[1:])

    xm, maskm = micro(x), micro(kv_mask)
    cosm, sinm = micro(cos), micro(sin)

    def body(layers, xm, maskm, cosm, sinm):
        s = jax.lax.axis_index("pipe")
        n_ticks = M + n_pipe - 1

        def run_stage(h, m):
            mk = jax.lax.dynamic_index_in_dim(maskm, m, 0, keepdims=False)
            co = jax.lax.dynamic_index_in_dim(cosm, m, 0, keepdims=False)
            si = jax.lax.dynamic_index_in_dim(sinm, m, 0, keepdims=False)

            def layer_step(hh, p):
                attn_out, _ = _attention(
                    p, rms_norm(p["ln1"], hh, cfg.rms_norm_eps), co, si,
                    None, cfg, kv_mask=mk, w8a8=w8a8)
                hh = hh + attn_out
                hh = hh + _mlp(p, rms_norm(p["ln2"], hh, cfg.rms_norm_eps),
                               w8a8)
                return hh, None

            if remat:
                layer_step = jax.checkpoint(layer_step)
            out, _ = jax.lax.scan(layer_step, h, layers)
            return out

        fwd = [(i, i + 1) for i in range(n_pipe - 1)]

        def tick(h_prev, t):
            h_in = jax.lax.ppermute(h_prev, "pipe", fwd)
            x0 = jax.lax.dynamic_index_in_dim(
                xm, jnp.clip(t, 0, M - 1), 0, keepdims=False)
            h_in = jnp.where(s == 0, x0, h_in)
            m = jnp.clip(t - s, 0, M - 1)
            y = run_stage(h_in, m)
            return y, y

        h0 = jnp.zeros((Bm, T, D), x.dtype)
        # the carry becomes device-varying after the first ppermute;
        # mark the (replicated) zeros init as varying up front
        h0 = jax.lax.pcast(h0, ("pipe",), to="varying")
        _, ys = jax.lax.scan(tick, h0, jnp.arange(n_ticks))
        # ticks P-1 .. M+P-2 of the LAST stage carry microbatch 0..M-1;
        # psum broadcasts them (every other stage contributes zeros)
        outs = ys[n_pipe - 1:]
        outs = jnp.where(s == n_pipe - 1, outs, jnp.zeros_like(outs))
        outs = jax.lax.psum(outs, "pipe")
        return outs

    from .sharding import suspend_activation_sharding

    with suspend_activation_sharding():
        out = jax.shard_map(
            body, mesh=mesh, axis_names={"pipe"},
            in_specs=(P("pipe"), P(), P(), P(), P()), out_specs=P(),
        )(layers, xm, maskm, cosm, sinm)
    return out.reshape(B, T, D)
