"""ORCA hybrid connector + gated cross-attention deep injection.

Reference: ``ORCAHybridConnector`` (modeling_desta25.py:208-357) and
``ORCAGatedCrossAttention`` (modeling_desta25.py:359-490).

- Global branch: Q-Former queries per tapped encoder layer
  (orca_global_num_tokens), weighted layer fusion, LN+Linear projection.
- Local branch: softmax layer fusion over taps -> Linear(d_enc->d_llm) ->
  Conv1d(kernel=orca_local_kernel_size, stride=orca_local_downsample,
  same-ish padding) -> LayerNorm.
- Deep injection: per-LLM-layer gated cross-attention
  ``h + sigmoid(MLP(h)) * LN(MHA(q=h, kv=RoPE(audio_local)))``; audio
  positions are fractional ``i / orca_audio_position_scale``.  The
  reference monkey-patches decoder layer forwards
  (modeling_desta25.py:1101-1141); here it is a first-class
  ``extra_layer_fn`` threaded through the LLM's layer scan, with per-layer
  alignment losses accumulated functionally in the scan carry.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import DeSTA25Config
from ..ops.core import (
    Params,
    conv1d,
    gelu,
    init_conv1d,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
    mha,
    stack_layers,
)
from ..ops.rope import fractional_rope_apply
from .qformer import bert_encoder_apply, init_bert_encoder


# ---------------------------------------------------------------------------
# Hybrid connector
# ---------------------------------------------------------------------------


def init_orca_connector(key, cfg: DeSTA25Config,
                        dtype=jnp.float32) -> Params:
    n_taps = len(cfg.target_layer_ids)
    d_enc = cfg.encoder_config.d_model
    d_llm = cfg.llm_config.hidden_size
    K = cfg.orca_global_num_tokens
    kq, kb, kp, kl, kc = jax.random.split(key, 5)
    p: Params = {
        "global_queries": jax.random.normal(kq, (n_taps, K, d_enc), dtype),
        "global_layer_weights": jnp.zeros((K, n_taps), jnp.float32),
        "global_qformer": init_bert_encoder(kb, cfg.qformer_config, dtype),
        "global_proj_ln": init_layer_norm(d_enc, dtype),
        "global_proj": init_linear(kp, d_enc, d_llm, dtype=dtype),
    }
    if cfg.orca_local_enabled:
        p["local_layer_weights"] = jnp.zeros((n_taps,), jnp.float32)
        p["local_proj_in"] = init_linear(kl, d_enc, d_llm, dtype=dtype)
        p["local_conv"] = init_conv1d(kc, d_llm, d_llm,
                                      cfg.orca_local_kernel_size, dtype)
        p["local_ln"] = init_layer_norm(d_llm, dtype)
    return p


def orca_connector_apply(params: Params, taps: jnp.ndarray,
                         cfg: DeSTA25Config
                         ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """taps: [n_taps, B, T_enc, d_enc].
    Returns (global_tokens [B, K, d_llm], local_tokens [B, T', d_llm]|None).
    """
    qcfg = cfg.qformer_config
    B = taps.shape[1]

    def one_tap(queries, enc_h):
        q = jnp.broadcast_to(queries[None], (B,) + queries.shape)
        return bert_encoder_apply(params["global_qformer"],
                                  q.astype(enc_h.dtype), enc_h, qcfg)

    outs = jax.vmap(one_tap)(params["global_queries"], taps)
    w = jax.nn.softmax(
        params["global_layer_weights"].astype(jnp.float32), axis=-1)
    fused = jnp.einsum("nbkd,kn->bkd", outs.astype(jnp.float32), w)
    fused = fused.astype(taps.dtype)
    fused = layer_norm(params["global_proj_ln"], fused, eps=1e-5)
    global_tokens = linear(params["global_proj"], fused)

    if not cfg.orca_local_enabled:
        return global_tokens, None

    lw = jax.nn.softmax(
        params["local_layer_weights"].astype(jnp.float32), axis=-1)
    local = jnp.einsum("nbtd,n->btd", taps.astype(jnp.float32), lw)
    local = linear(params["local_proj_in"], local.astype(taps.dtype))
    local = conv1d(params["local_conv"], local,
                   stride=cfg.orca_local_downsample,
                   padding=cfg.orca_local_kernel_size // 2)
    local_tokens = layer_norm(params["local_ln"], local, eps=1e-5)
    return global_tokens, local_tokens


# ---------------------------------------------------------------------------
# Gated cross-attention (deep injection)
# ---------------------------------------------------------------------------


def init_orca_cross_attns(key, cfg: DeSTA25Config,
                          dtype=jnp.float32) -> Params:
    """One gated cross-attn block per LLM decoder layer, stacked."""
    d = cfg.llm_config.hidden_size
    layers = []
    for _ in range(cfg.llm_config.num_hidden_layers):
        key, kq, kk, kv, ko, kg1, kg2 = jax.random.split(key, 7)
        g1 = init_linear(kg1, d, d // 4, dtype=dtype)
        # gate output layer: zero weight, bias = gate_init (stable start,
        # modeling_desta25.py:381-384)
        g2 = {"w": jnp.zeros((d // 4, 1), dtype),
              "b": jnp.full((1,), cfg.orca_gate_init, dtype)}
        layers.append({
            "q": init_linear(kq, d, d, dtype=dtype),
            "k": init_linear(kk, d, d, dtype=dtype),
            "v": init_linear(kv, d, d, dtype=dtype),
            "o": init_linear(ko, d, d, dtype=dtype),
            "gate1": g1,
            "gate2": g2,
            "ln": init_layer_norm(d, dtype),
        })
    return {"layers": stack_layers(layers)}


def _xattn_linear(p: Params, x: jnp.ndarray) -> jnp.ndarray:
    """Linear that routes int8 leaves (ops.quant.quantize_orca_cross_attns)
    through quant_matmul's weight-only dequant-dot — ops.core.linear's
    int8 dispatch is act-quant-always, the wrong regime for per-step
    decode projections."""
    if "w" in p:
        return linear(p, x)
    from ..ops.quant import quant_matmul
    y = quant_matmul(x, p)
    if "b" in p:
        y = (y.astype(jnp.float32)
             + p["b"].astype(jnp.float32)).astype(y.dtype)
    return y


def gated_cross_attention_apply(
    p: Params,
    hidden: jnp.ndarray,        # [B, T, D]
    audio_roped: jnp.ndarray,   # [B, Ta, D] (already RoPE'd); may be None
    n_heads: int,
    cached_kv=None,             # ([B, Ta, D], [B, Ta, D]) from
    #                             precompute_cross_kv — skips the k/v
    #                             projections (they are loop-invariant in
    #                             decode: recomputing them every step cost
    #                             ~92 GFLOP/layer/step at the flagship)
) -> jnp.ndarray:
    B, T, D = hidden.shape
    dh = D // n_heads
    q = _xattn_linear(p["q"], hidden).reshape(B, T, n_heads, dh)
    if cached_kv is None:
        Ta = audio_roped.shape[1]
        k = _xattn_linear(p["k"], audio_roped).reshape(B, Ta, n_heads, dh)
        v = _xattn_linear(p["v"], audio_roped).reshape(B, Ta, n_heads, dh)
    else:
        kf, vf = cached_kv
        Ta = kf.shape[1]
        k = kf.astype(hidden.dtype).reshape(B, Ta, n_heads, dh)
        v = vf.astype(hidden.dtype).reshape(B, Ta, n_heads, dh)
    attn = mha(q, k, v).reshape(B, T, D)
    attn = _xattn_linear(p["o"], attn)
    attn = layer_norm(p["ln"], attn, eps=1e-5)
    gate = jax.nn.sigmoid(
        _xattn_linear(p["gate2"], gelu(_xattn_linear(p["gate1"], hidden))
                      ).astype(jnp.float32))
    return hidden + (gate * attn.astype(jnp.float32)).astype(hidden.dtype)


def precompute_cross_kv(orca_params: Params, audio_roped: jnp.ndarray):
    """Per-layer audio K/V for the gated cross-attention: two
    [L, B, Ta, D] arrays (layer-stacked, matching ``orca_params["layers"]``).

    The audio tokens — and therefore every layer's k/v projections of
    them — are constant across decode steps; computing them once per
    request turns ~L x 92 GFLOP/step of re-projection (flagship: 3.3
    TFLOP/step, dominating the 4B tower itself) into a one-time cost."""
    def one(lp):
        return (_xattn_linear(lp["k"], audio_roped),
                _xattn_linear(lp["v"], audio_roped))

    return jax.vmap(one)(orca_params["layers"])


def make_deep_injection_fn(
    orca_params: Params,
    cfg: DeSTA25Config,
    audio_local: jnp.ndarray,           # [B, Ta, d_llm]
    trans_pos_mask: Optional[jnp.ndarray] = None,  # [B, T] 1 where
    #                                      transcription embeddings sit
    training: bool = False,
):
    """Build the ``extra_layer_fn`` for :func:`llm.llm_apply` plus the aux
    init for per-layer alignment losses.

    Returns (extra_layer_fn, aux_init) where aux carries
    (align_loss_sum, layer_count); mean = sum / count (count 0 when no
    transcription positions exist — prompt-only training has empty
    transcriptions so the reference's loss list stays empty,
    modeling_desta25.py:459-476).
    """
    n_heads = cfg.llm_config.num_attention_heads
    roped = fractional_rope_apply(audio_local,
                                  cfg.orca_audio_position_scale,
                                  cfg.llm_config.rope_theta)
    audio_pooled = jax.lax.stop_gradient(
        _l2norm(jnp.mean(roped.astype(jnp.float32), axis=1)))  # [B, D]

    have_trans = (trans_pos_mask is not None and training)

    def fn(idx, hidden, aux):
        layer_p = jax.tree.map(lambda x: x[idx], orca_params["layers"])
        new_hidden = gated_cross_attention_apply(layer_p, hidden, roped,
                                                 n_heads)
        if have_trans:
            m = trans_pos_mask.astype(jnp.float32)[..., None]
            counts = jnp.sum(m, axis=1)  # [B, 1]
            pooled = jnp.sum(hidden.astype(jnp.float32) * m, axis=1) \
                / jnp.maximum(counts, 1.0)
            pooled = _l2norm(pooled)
            has = (counts[:, 0] > 0).astype(jnp.float32)
            cos = jnp.sum(audio_pooled * pooled, axis=-1)
            per_layer = (jnp.sum((1.0 - cos) * has)
                         / jnp.maximum(jnp.sum(has), 1.0))
            valid = (jnp.sum(has) > 0).astype(jnp.float32)
            aux = (aux[0] + per_layer * valid, aux[1] + valid)
        return new_hidden, aux

    aux_init = (jnp.float32(0.0), jnp.float32(0.0))
    return fn, aux_init


def _l2norm(x: jnp.ndarray) -> jnp.ndarray:
    # sqrt(sum(x^2) + eps^2), NOT linalg.norm(x) + eps: the norm's own
    # backward at x == 0 is 0/0 = NaN, and masking the loss value
    # afterwards cannot undo it (NaN * 0 = NaN).  Rows with no
    # transcription positions pool to exactly zero, which silently
    # NaN-ed every connector gradient (found via bench_train_orca).
    sq = jnp.sum(jnp.square(x), axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(sq + 1e-12)
