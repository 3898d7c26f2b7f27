"""Q-Former audio-text connector.

Reimplements the reference ``QformerConnector`` (modeling_desta25.py:126-205):
a BERT-style post-LN transformer with cross-attention (HF ``BertEncoder``
with ``is_decoder=True, add_cross_attention=True`` called without masks, so
self-attention over the queries is fully bidirectional), one learnable
prompt of ``prompt_size`` queries per tapped encoder layer, a learnable
per-(query, layer) softmax fusion, and a LayerNorm+Linear projection to the
LLM width.

BERT specifics preserved: intermediate_size stays at BertConfig's default
3072 regardless of hidden size, GELU, LayerNorm eps 1e-12.

The per-tap Q-Former passes run as one ``jax.vmap`` over the tap axis (the
reference loops in Python, modeling_desta25.py:575-598), so all taps batch
into single large matmuls.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import DeSTA25Config, QFormerConfig
from ..ops.core import (
    Params,
    gelu,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
    normal_init,
    stack_layers,
)

_BERT_EPS = 1e-12


def _init_bert_attn(key, d: int, dtype) -> Params:
    kq, kk, kv, ko = jax.random.split(key, 4)
    return {
        "q": init_linear(kq, d, d, dtype=dtype),
        "k": init_linear(kk, d, d, dtype=dtype),
        "v": init_linear(kv, d, d, dtype=dtype),
        "o": init_linear(ko, d, d, dtype=dtype),
        "ln": init_layer_norm(d, dtype),
    }


def _init_bert_layer(key, cfg: QFormerConfig, dtype) -> Params:
    ks, kx, ki, ko = jax.random.split(key, 4)
    d = cfg.hidden_size
    return {
        "self": _init_bert_attn(ks, d, dtype),
        "cross": _init_bert_attn(kx, d, dtype),
        "inter": init_linear(ki, d, cfg.intermediate_size, dtype=dtype),
        "out": init_linear(ko, cfg.intermediate_size, d, dtype=dtype),
        "out_ln": init_layer_norm(d, dtype),
    }


def init_bert_encoder(key, cfg: QFormerConfig, dtype=jnp.float32) -> Params:
    keys = jax.random.split(key, cfg.num_hidden_layers)
    return {"layers": stack_layers(
        [_init_bert_layer(k, cfg, dtype) for k in keys])}


def _bert_attn_apply(p: Params, q_in, kv_in, n_heads: int,
                     kv=None) -> jnp.ndarray:
    """kv: optional precomputed (k, v) [B, T_kv, D] — skips the K/V
    projections (see :func:`bert_encoder_apply`)."""
    from ..ops.attention import mha
    B, T, D = q_in.shape
    dh = D // n_heads
    q = linear(p["q"], q_in).reshape(B, T, n_heads, dh)
    k, v = kv if kv is not None else (linear(p["k"], kv_in),
                                      linear(p["v"], kv_in))
    t_kv = k.shape[1]
    out = mha(q, k.reshape(B, t_kv, n_heads, dh),
              v.reshape(B, t_kv, n_heads, dh)).reshape(B, T, D)
    out = linear(p["o"], out)
    return layer_norm(p["ln"], out + q_in, _BERT_EPS)


def _quant_rows(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-row dynamic int8 activation quant: [.., K] -> (q int8 [M, K],
    s f32 [M, 1]) with M = prod(leading dims)."""
    K = x.shape[-1]
    xf = x.reshape(-1, K).astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True),
                    1e-8) / 127.0
    q = jnp.round(xf / s).astype(jnp.int8)
    return q, s


def _int8_kv_linear(p: Params, qx: jnp.ndarray, sx: jnp.ndarray,
                    shape, dtype) -> jnp.ndarray:
    """K/V projection from pre-quantized activations: quantize the
    (bf16, trainable) weight on the fly — O(K*N), negligible — and run
    an int8 x int8 -> int32 dot.  One activation-quant pass is shared by
    all 2 x L cross K/V projections."""
    w = p["w"].astype(jnp.float32)
    ws = jnp.maximum(jnp.max(jnp.abs(w), axis=0), 1e-8) / 127.0
    qw = jnp.round(w / ws[None, :]).astype(jnp.int8)
    y = jax.lax.dot_general(qx, qw, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    y = y.astype(jnp.float32) * sx * ws[None, :]
    if "b" in p:
        y = y + p["b"].astype(jnp.float32)
    return y.reshape(shape).astype(dtype)


def bert_encoder_apply(params: Params, hidden: jnp.ndarray,
                       encoder_hidden: jnp.ndarray,
                       cfg: QFormerConfig, w8a8: bool = False) -> jnp.ndarray:
    """hidden: [B, K, D] queries; encoder_hidden: [B, T, D] cross source.

    w8a8 (inference only): dynamic-int8 cross K/V projections, the
    connector's dominant cost (2 x L matmuls over every encoder frame);
    training callers must leave it False (round() has zero gradient)."""
    H = cfg.num_attention_heads
    if w8a8:
        # one activation-quant pass shared by every layer's cross K/V
        qx, sx = _quant_rows(encoder_hidden)
        kv_shape = encoder_hidden.shape
        kv_dtype = encoder_hidden.dtype

    # remat: without it, scan AD stacks each layer's cross k/v (tap-shaped
    # [B, T, D] bf16) as per-layer residuals — 6 x 2 x ~176 MB at flagship
    # training scale (the single largest HBM temp before this fix).
    # Identity for forward-only inference.
    @jax.checkpoint
    def body(h, p):
        h = _bert_attn_apply(p["self"], h, h, H)
        kv = None
        if w8a8:
            kv = (_int8_kv_linear(p["cross"]["k"], qx, sx, kv_shape,
                                  kv_dtype),
                  _int8_kv_linear(p["cross"]["v"], qx, sx, kv_shape,
                                  kv_dtype))
        h = _bert_attn_apply(p["cross"], h, encoder_hidden, H, kv=kv)
        inter = gelu(linear(p["inter"], h))
        out = linear(p["out"], inter)
        h = layer_norm(p["out_ln"], out + h, _BERT_EPS)
        return h, None

    h, _ = jax.lax.scan(body, hidden, params["layers"])
    return h


# ---------------------------------------------------------------------------
# Connector
# ---------------------------------------------------------------------------


def init_qformer_connector(key, cfg: DeSTA25Config,
                           dtype=jnp.float32) -> Params:
    qcfg = cfg.qformer_config
    n_taps = len(cfg.target_layer_ids)
    d_enc = cfg.encoder_config.d_model
    d_llm = cfg.llm_config.hidden_size
    kp, kq, kproj = jax.random.split(key, 3)
    return {
        # torch.randn init (std 1.0) — modeling_desta25.py:148-150.
        "layer_prompts": jax.random.normal(
            kp, (n_taps, cfg.prompt_size, d_enc), dtype),
        "layer_weights": jnp.zeros((cfg.prompt_size, n_taps), jnp.float32),
        "qformer": init_bert_encoder(kq, qcfg, dtype),
        "proj_ln": init_layer_norm(d_enc, dtype),
        "proj": init_linear(kproj, d_enc, d_llm, dtype=dtype),
    }


def qformer_connector_apply(params: Params, taps: jnp.ndarray,
                            cfg: DeSTA25Config,
                            w8a8: bool = False) -> jnp.ndarray:
    """taps: [n_taps, B, T_enc, d_enc] tapped encoder layer outputs.
    Returns audio tokens [B, prompt_size, d_llm].  w8a8: inference-only
    dynamic-int8 cross K/V projections; keep False when training."""
    qcfg = cfg.qformer_config
    n_taps, B = taps.shape[0], taps.shape[1]

    def one_tap(prompt, enc_h):
        queries = jnp.broadcast_to(prompt[None], (B,) + prompt.shape)
        return bert_encoder_apply(params["qformer"], queries.astype(enc_h.dtype),
                                  enc_h, qcfg, w8a8=w8a8)

    outs = jax.vmap(one_tap)(params["layer_prompts"], taps)
    # [n_taps, B, K, d_enc] -> weighted sum over taps with per-query softmax
    w = jax.nn.softmax(params["layer_weights"].astype(jnp.float32), axis=-1)
    fused = jnp.einsum("nbkd,kn->bkd", outs.astype(jnp.float32), w)
    fused = fused.astype(taps.dtype)
    fused = layer_norm(params["proj_ln"], fused, eps=1e-5)
    return linear(params["proj"], fused)
