"""Decoder-only LLM (Llama-3.x / Qwen3 family) in functional JAX.

Replaces the reference's frozen HF ``AutoModelForCausalLM``
(modeling_desta25.py:713-718) as the language backbone: RMSNorm, RoPE
(llama3 NTK scaling or plain theta), GQA attention, SwiGLU MLP, optional
Qwen3 per-head q/k RMSNorm, optional tied embeddings, optional LoRA on
q/k/v (reference LoRA target modules, modeling_desta25.py:720-729).

All layers run under one ``lax.scan`` over stacked parameters.  Designed to
accept ``inputs_embeds`` directly so the DeSTA audio-token splice can feed
it (reference forward contract, modeling_desta25.py:758-938), and to run
prefill + single-step decode against a preallocated KV cache for
generation.  Activation sharding constraints are applied through
``parallel.sharding.shard_activation`` ("data" over batch, "model" over
heads/ffn).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import LLMConfig
from ..ops.core import (
    Params,
    init_rms_norm,
    normal_init,
    rms_norm,
)
from ..ops.rope import apply_rope, llm_rope_cos_sin
from ..parallel.sharding import shard_activation


class KVCache(NamedTuple):
    """Packed KV cache: heads folded into the last axis,
    [L, B, Tmax, Hkv*Dh], one array for all layers (the layer scan
    slices it)."""
    k: jnp.ndarray  # [L, B, Tmax, Hkv * Dh]
    v: jnp.ndarray  # [L, B, Tmax, Hkv * Dh]


def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int,
                  dtype=jnp.bfloat16) -> KVCache:
    shape = (cfg.num_hidden_layers, batch, max_len,
             cfg.num_key_value_heads * cfg.head_dim)
    k = jnp.zeros(shape, dtype)
    v = jnp.zeros(shape, dtype)
    # under a mesh the packed head axis shards over "model" (matches the
    # wk/wv output sharding, so cached k/v land where they're produced);
    # no-op without a mesh
    if shape[3] % _model_axis_or_1() == 0:
        k = shard_activation(k, (None, None, None, "model"))
        v = shard_activation(v, (None, None, None, "model"))
    return KVCache(k, v)


def _model_axis_or_1() -> int:
    from ..parallel.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return mesh.shape["model"]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_layer(key, cfg: LLMConfig, dtype) -> Params:
    kq, kk, kv, ko, kg, ku, kd = jax.random.split(key, 7)
    D = cfg.hidden_size
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    p = {
        "ln1": init_rms_norm(D, dtype),
        "wq": normal_init(kq, (D, H * Dh), 0.02, dtype),
        "wk": normal_init(kk, (D, Hkv * Dh), 0.02, dtype),
        "wv": normal_init(kv, (D, Hkv * Dh), 0.02, dtype),
        "wo": normal_init(ko, (H * Dh, D), 0.02, dtype),
        "ln2": init_rms_norm(D, dtype),
        "w_gate": normal_init(kg, (D, cfg.intermediate_size), 0.02, dtype),
        "w_up": normal_init(ku, (D, cfg.intermediate_size), 0.02, dtype),
        "w_down": normal_init(kd, (cfg.intermediate_size, D), 0.02, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(Dh, dtype)
        p["k_norm"] = init_rms_norm(Dh, dtype)
    return p


def init_llm(key, cfg: LLMConfig, dtype=jnp.bfloat16) -> Params:
    ke, kh, *lkeys = jax.random.split(key, 2 + cfg.num_hidden_layers)
    layers = [_init_layer(k, cfg, dtype) for k in lkeys]
    from ..ops.core import stack_layers
    p = {
        "embed": normal_init(ke, (cfg.vocab_size, cfg.hidden_size), 0.02,
                             dtype),
        "layers": stack_layers(layers),
        "norm": init_rms_norm(cfg.hidden_size, dtype),
    }
    if not cfg.tie_word_embeddings:
        p["lm_head"] = normal_init(kh, (cfg.hidden_size, cfg.vocab_size),
                                   0.02, dtype)
    return p


def init_lora(key, cfg: LLMConfig, rank: int, dtype=jnp.float32) -> Params:
    """LoRA A/B for q/k/v of every layer (A ~ N(0, 0.02), B zero)."""
    D = cfg.hidden_size
    outs = {"q": cfg.num_attention_heads * cfg.head_dim,
            "k": cfg.num_key_value_heads * cfg.head_dim,
            "v": cfg.num_key_value_heads * cfg.head_dim}
    layers = []
    for i in range(cfg.num_hidden_layers):
        key, *ks = jax.random.split(key, 4)
        layers.append({
            t: {"a": normal_init(k, (D, rank), 0.02, dtype),
                "b": jnp.zeros((rank, outs[t]), dtype)}
            for t, k in zip(("q", "k", "v"), ks)
        })
    from ..ops.core import stack_layers
    return {"layers": stack_layers(layers)}


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _head_logits(params: Params, cfg: LLMConfig,
                 hidden: jnp.ndarray, w8a8: bool = False) -> jnp.ndarray:
    """Final-hidden -> vocab logits (tied / untied / quantized heads)."""
    head = params.get("lm_head")
    from ..ops.quant import is_quantized, quant_matmul
    if head is None:
        return jnp.einsum("btd,vd->btv", hidden, params["embed"],
                          preferred_element_type=jnp.float32)
    if is_quantized(head):
        return quant_matmul(hidden, head, out_dtype=jnp.float32, w8a8=w8a8)
    return jnp.einsum("btd,dv->btv", hidden, head,
                      preferred_element_type=jnp.float32)


def _proj(x, w, w8a8: bool = False):
    from ..ops.quant import is_quantized, quant_matmul
    if is_quantized(w):
        return quant_matmul(x, w, w8a8=w8a8)
    return jnp.dot(x, w, preferred_element_type=jnp.float32).astype(x.dtype)


def _lora_delta(x, lp, scale: float, dropout: float = 0.0, key=None):
    """peft LoRA delta: scale * dropout(x) @ A @ B with scale = alpha/r
    (reference modeling_desta25.py:720-729).  Dropout (train-time only,
    when a key is provided) is applied to the adapter INPUT, matching
    ``peft.tuners.lora`` semantics."""
    if key is not None and dropout > 0.0:
        keep = jax.random.bernoulli(key, 1.0 - dropout, x.shape)
        x = jnp.where(keep, x, jnp.zeros_like(x)) / jnp.asarray(
            1.0 - dropout, x.dtype)
    a = jnp.dot(x, lp["a"].astype(x.dtype),
                preferred_element_type=jnp.float32)
    return scale * jnp.dot(a, lp["b"].astype(a.dtype),
                           preferred_element_type=jnp.float32)


def _attention(p: Params, x: jnp.ndarray, cos, sin, mask, cfg: LLMConfig,
               layer_cache=None, cache_index=None, lora=None,
               lora_scale: float = 1.0, lora_dropout: float = 0.0,
               lora_key=None, kv_mask=None, w8a8: bool = False):
    """One attention block.

    ``kv_mask`` [B, T] set: attention over this call's own T keys
    (causal, padded keys masked) through ``ops.attention.mha`` — training,
    and prefill into a fresh cache.  Otherwise: attention over the whole
    cache under the dense ``mask`` [B, 1, T, Tmax] (cached decode and
    speculative verify)."""
    B, T, D = x.shape
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    q = _proj(x, p["wq"], w8a8)
    k = _proj(x, p["wk"], w8a8)
    v = _proj(x, p["wv"], w8a8)
    if lora is not None:
        # independent dropout masks per adapter (peft has one nn.Dropout
        # instance per wrapped Linear)
        keys = (jax.random.split(lora_key, 3) if lora_key is not None
                else (None, None, None))
        q = (q.astype(jnp.float32)
             + _lora_delta(x, lora["q"], lora_scale, lora_dropout,
                           keys[0])).astype(q.dtype)
        k = (k.astype(jnp.float32)
             + _lora_delta(x, lora["k"], lora_scale, lora_dropout,
                           keys[1])).astype(k.dtype)
        v = (v.astype(jnp.float32)
             + _lora_delta(x, lora["v"], lora_scale, lora_dropout,
                           keys[2])).astype(v.dtype)
    q = q.reshape(B, T, H, Dh)
    k = k.reshape(B, T, Hkv, Dh)
    v = v.reshape(B, T, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.rms_norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if layer_cache is not None:
        ck, cv = layer_cache  # [B, Tmax, Hkv*Dh] packed (see KVCache)
        kf = k.reshape(B, T, Hkv * Dh).astype(ck.dtype)
        vf = v.reshape(B, T, Hkv * Dh).astype(cv.dtype)
        ci = jnp.asarray(cache_index)
        if ci.ndim == 0:
            ck = jax.lax.dynamic_update_slice(ck, kf, (0, ci, 0))
            cv = jax.lax.dynamic_update_slice(cv, vf, (0, ci, 0))
        else:
            # per-row write offsets (continuous batching: every slot sits
            # at its own decode position)
            def upd(c_row, new_row, i):
                return jax.lax.dynamic_update_slice(c_row, new_row, (i, 0))
            ck = jax.vmap(upd)(ck, kf, ci)
            cv = jax.vmap(upd)(cv, vf, ci)
        new_cache = (ck, cv)

    if kv_mask is not None:
        from ..ops.attention import mha
        out = mha(q, k.astype(q.dtype), v.astype(q.dtype), causal=True,
                  kv_mask=kv_mask)
    else:
        ck, cv = new_cache
        S_c = ck.shape[1]
        k = ck.reshape(B, S_c, Hkv, Dh)
        v = cv.reshape(B, S_c, Hkv, Dh)
        # Grouped-query einsum keeps K/V un-repeated (repeating them would
        # multiply the cache bytes each step reads by H / Hkv).
        G = H // Hkv
        qg = q.reshape(B, T, Hkv, G, Dh)
        logits = jnp.einsum("btkgd,bskd->bkgts", qg, k,
                            preferred_element_type=jnp.float32)
        logits = logits * (Dh ** -0.5)
        # mask: [B, 1|H, T, S] -> [B, 1, 1, T, S] broadcast over (k, g)
        m = mask if mask.ndim == 4 else mask[:, None]
        logits = jnp.where(m[:, :1, None], logits, jnp.float32(-1e30))
        probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        out = jnp.einsum("bkgts,bskd->btkgd", probs, v,
                         preferred_element_type=jnp.float32).astype(x.dtype)
        out = out.reshape(B, T, H, Dh)
    out = shard_activation(out, ("data", None, "model", None))
    out = out.reshape(B, T, H * Dh)
    return _proj(out, p["wo"], w8a8), new_cache


def _mlp(p: Params, x: jnp.ndarray, w8a8: bool = False) -> jnp.ndarray:
    g = _proj(x, p["w_gate"], w8a8)
    u = _proj(x, p["w_up"], w8a8)
    h = jax.nn.silu(g.astype(jnp.float32)).astype(x.dtype) * u
    h = shard_activation(h, ("data", None, "model"))
    return _proj(h, p["w_down"], w8a8)


def llm_apply(
    params: Params,
    cfg: LLMConfig,
    *,
    input_ids: Optional[jnp.ndarray] = None,
    inputs_embeds: Optional[jnp.ndarray] = None,
    attention_mask: Optional[jnp.ndarray] = None,
    positions: Optional[jnp.ndarray] = None,
    cache: Optional[KVCache] = None,
    cache_index=None,
    lora: Optional[Params] = None,
    lora_scale: float = 1.0,
    lora_dropout: float = 0.0,
    lora_rng: Optional[jax.Array] = None,
    extra_layer_fn=None,
    extra_aux_init=None,
    return_hidden: bool = False,
    remat: bool = False,
    skip_head: bool = False,
    w8a8: bool = False,
    pipeline_microbatches: Optional[int] = None,
    sequence_parallel: bool = False,
):
    """Forward pass.

    input_ids [B, T] or inputs_embeds [B, T, D] (exactly one).
    attention_mask: [B, T] 1/0 (left padding supported).  With a cache it
    must cover the cache length [B, Tmax].
    positions: [B, T] explicit RoPE positions; default cumsum(mask)-1.
    cache / cache_index: KV-cached call — writes the new k/v at
    ``cache_index`` (scalar, or [B] per-row offsets).  A call at the
    static ``cache_index=0`` is a prefill into a fresh cache and attends
    its own T keys; any other attends over the full cache (decode, and
    the T = Kd multi-token speculative verify).
    lora_scale: peft alpha/r multiplier on the LoRA delta; lora_dropout +
    lora_rng enable train-time dropout on the adapter input (reference
    LoRA config r=16, alpha=16, dropout 0.1 — modeling_desta25.py:720-729).
    extra_layer_fn: optional ``fn(layer_idx, hidden) -> hidden`` — or, when
    ``extra_aux_init`` is given, ``fn(layer_idx, hidden, aux) ->
    (hidden, aux)`` with ``aux`` threaded through the layer scan — applied
    after each decoder layer (ORCA gated cross-attention deep injection —
    first-class here, not monkey-patched; cf. modeling_desta25.py:1052-1143).
    return_hidden: also return final hidden states (pre-logits) and, when
    True, per-layer hidden states are NOT stashed (cheap).
    sequence_parallel: Megatron-style sequence parallelism for the
    cache-less (training/prefill) scan path: the residual stream is
    constrained to ("data", "model") over (batch, seq) at every layer
    boundary, so the norms/residual adds/connector activations live
    seq-sharded and GSPMD turns the wo/w_down all-reduce into a
    reduce-scatter + all-gather pair around each block.  Cuts the
    per-device residual-stream activation memory by the "model" axis
    size.  No-op off-mesh, under a cache (decode), or inside the GPipe
    pipeline body (activation constraints are suspended there).

    w8a8: int8 towers run prefill-sized matmuls as W8A8 (per-row dynamic
    activation quant, ops/quant.py) instead of the weight-only
    dequant-dot.  Off by default: it changes the model's numerics.

    Returns (logits [B, T, V] float32, new_cache, hidden or None); with
    ``extra_aux_init`` a 4th element carries the final aux value.
    """
    if (input_ids is None) == (inputs_embeds is None):
        raise ValueError("provide exactly one of input_ids / inputs_embeds")
    if inputs_embeds is None:
        inputs_embeds = params["embed"][input_ids]
    x = inputs_embeds
    B, T, D = x.shape
    seq_par = bool(sequence_parallel) and cache is None
    x = shard_activation(x, ("data", "model" if seq_par else None, None))

    mask = kv_mask = None
    if cache is not None:
        Tmax = cache.k.shape[2]
        if attention_mask is None:
            attention_mask = jnp.ones((B, Tmax), jnp.int32)
        ci = jnp.asarray(cache_index)
        if positions is None:
            positions = (ci + jnp.arange(T)[None, :] if ci.ndim == 0
                         else ci[:, None] + jnp.arange(T)[None, :])
        if isinstance(cache_index, int) and cache_index == 0:
            # prefill into a fresh cache: keys past T are empty, so
            # attending the call's own keys under a causal mask is exact
            kv_mask = attention_mask[:, :T]
        else:
            key_pos = jnp.arange(Tmax)[None, None, None, :]
            if ci.ndim == 0:
                q_pos = (ci + jnp.arange(T))[None, None, :, None]
            else:  # [B] per-row offsets
                q_pos = (ci[:, None]
                         + jnp.arange(T)[None, :])[:, None, :, None]
            mask = ((key_pos <= q_pos)
                    & (attention_mask[:, None, None, :] > 0))
    else:
        if attention_mask is None:
            attention_mask = jnp.ones((B, T), jnp.int32)
        kv_mask = attention_mask
        if positions is None:
            positions = jnp.maximum(
                jnp.cumsum(attention_mask, axis=1) - 1, 0)

    cos, sin = llm_rope_cos_sin(cfg, positions)

    # Pipeline-parallel layer stack (GPipe fill-drain over the "pipe"
    # mesh axis, parallel/pipeline.py) — training forward only: no
    # cache / LoRA / per-layer hooks.
    if (cache is None and pipeline_microbatches and lora is None
            and extra_layer_fn is None and extra_aux_init is None):
        from ..parallel.pipeline import (
            pipeline_decoder_hidden,
            pipeline_enabled,
        )
        if pipeline_enabled():
            x = pipeline_decoder_hidden(
                params["layers"], cfg, x, kv_mask, cos, sin,
                n_micro=pipeline_microbatches, remat=remat, w8a8=w8a8)
            hidden = rms_norm(params["norm"], x, cfg.rms_norm_eps)
            logits = (None if skip_head
                      else _head_logits(params, cfg, hidden, w8a8))
            return logits, None, (hidden if return_hidden else None)

    n_layers = cfg.num_hidden_layers
    layer_ids = jnp.arange(n_layers)

    def layer_step(carry, inp):
        if extra_aux_init is not None:
            h, aux = carry
        else:
            h, aux = carry, None
        if cache is not None:
            p, idx, lp, ck, cv = inp
            layer_cache = (ck, cv)
        else:
            p, idx, lp = inp
            layer_cache = None
        lkey = (jax.random.fold_in(lora_rng, idx)
                if (lora_rng is not None and lora_dropout > 0.0) else None)
        attn_out, new_lc = _attention(
            p, rms_norm(p["ln1"], h, cfg.rms_norm_eps), cos, sin, mask, cfg,
            layer_cache, cache_index, lp, lora_scale, lora_dropout, lkey,
            kv_mask=kv_mask, w8a8=w8a8)
        h = h + attn_out
        h = h + _mlp(p, rms_norm(p["ln2"], h, cfg.rms_norm_eps), w8a8)
        if extra_layer_fn is not None:
            if extra_aux_init is not None:
                h, aux = extra_layer_fn(idx, h, aux)
            else:
                h = extra_layer_fn(idx, h)
        if seq_par:
            # residual stream seq-sharded between blocks (Megatron SP)
            h = shard_activation(h, ("data", "model", None))
        carry = (h, aux) if extra_aux_init is not None else h
        return carry, new_lc

    if remat:
        layer_step = jax.checkpoint(layer_step)

    lora_layers = lora["layers"] if lora is not None else None
    carry0 = (x, extra_aux_init) if extra_aux_init is not None else x
    if cache is not None:
        xs = (params["layers"], layer_ids, lora_layers, cache.k, cache.v) \
            if lora is not None else \
            (params["layers"], layer_ids, None, cache.k, cache.v)
        # lax.scan can't carry None in xs; expand manually.
        if lora is None:
            def step(c, inp):
                p, idx, ck, cv = inp
                return layer_step(c, (p, idx, None, ck, cv))
            out, lcs = jax.lax.scan(
                step, carry0, (params["layers"], layer_ids, cache.k, cache.v))
        else:
            out, lcs = jax.lax.scan(layer_step, carry0, xs)
        new_cache = KVCache(lcs[0], lcs[1])
    else:
        if lora is None:
            def step(c, inp):
                p, idx = inp
                return layer_step(c, (p, idx, None))
            out, _ = jax.lax.scan(step, carry0,
                                  (params["layers"], layer_ids))
        else:
            out, _ = jax.lax.scan(layer_step, carry0,
                                  (params["layers"], layer_ids, lora_layers))
        new_cache = None
    if extra_aux_init is not None:
        x, extra_aux = out
    else:
        x, extra_aux = out, None

    hidden = rms_norm(params["norm"], x, cfg.rms_norm_eps)
    # skip_head: callers that consume hidden directly (e.g. the chunked
    # training CE, which never materializes [B, T, V] logits) skip the
    # full-sequence head matmul here.
    logits = None if skip_head else _head_logits(params, cfg, hidden, w8a8)
    if extra_aux_init is not None:
        return logits, new_cache, (hidden if return_hidden else None), \
            extra_aux
    if return_hidden:
        return logits, new_cache, hidden
    return logits, new_cache, None


def embed_tokens(params: Params, ids: jnp.ndarray) -> jnp.ndarray:
    """Embedding lookup (the splice needs raw embeddings;
    modeling_desta25.py:975-982)."""
    return params["embed"][ids]


def merge_lora(params: Params, lora: Params,
               lora_scale: float = 1.0) -> Params:
    """Fold LoRA adapters into the base q/k/v weights (peft
    ``merge_and_unload``): W' = W + scale * A @ B.

    A serving transform: the merged tree decodes WITHOUT the lora
    argument, so serving can speculate and int8-quantize the tower
    (quantize the merged tree with ops.quant.quantize_llm_params
    afterwards — merging must happen on the unquantized base).  Exact
    at inference: LoRA dropout is train-time only, so
    ``x @ W + scale * (x @ A) @ B == x @ (W + scale * A @ B)`` up to
    dtype rounding."""
    from ..ops.quant import is_quantized
    targets = {"q": "wq", "k": "wk", "v": "wv"}
    layers = dict(params["layers"])
    for t, wkey in targets.items():
        if is_quantized(layers[wkey]):
            raise ValueError(
                "merge_lora needs the unquantized base weights "
                f"({wkey} is int8) — merge first, then quantize")
        lp = lora["layers"][t]
        delta = jnp.einsum(
            "ldr,lrn->ldn", lp["a"].astype(jnp.float32),
            lp["b"].astype(jnp.float32)) * lora_scale
        w = layers[wkey]
        layers[wkey] = (w.astype(jnp.float32) + delta).astype(w.dtype)
    return {**params, "layers": layers}
