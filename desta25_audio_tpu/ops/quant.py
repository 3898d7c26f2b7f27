"""int8 quantization of the frozen towers' matmul weights.

Decode reads every weight once per step, so it is bound by weight bytes:
storing the matmul weights as int8 with per-output-channel scales halves
them.  Every quantized matmul is plain XLA: a dequantize-then-dot, or,
when the caller asks for it, W8A8 (per-row dynamic activation quant and
an int8 x int8 -> int32 dot) at prefill-sized row counts.

Representation: a quantized leaf is ``{"q": int8 [in, out],
"s": float32 [out]}``; ``models.llm`` consumes it transparently.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np

import jax
import jax.numpy as jnp

QuantLeaf = Dict[str, jnp.ndarray]


def quantize_weight(w: jnp.ndarray) -> QuantLeaf:
    """[in, out] float -> symmetric per-out-channel int8."""
    wf = w.astype(jnp.float32)
    scale = jnp.max(jnp.abs(wf), axis=0) / 127.0
    scale = jnp.maximum(scale, 1e-8)
    q = jnp.clip(jnp.round(wf / scale[None, :]), -127, 127).astype(jnp.int8)
    return {"q": q, "s": scale}


def dequantize_weight(leaf: QuantLeaf, dtype=jnp.bfloat16) -> jnp.ndarray:
    return (leaf["q"].astype(jnp.float32) * leaf["s"][None, :]).astype(dtype)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "s" in leaf


# W8A8 takes the int8 tensor cores from this many rows up (prefill);
# below it the matmul is bound by weight bytes and a dequant-dot is as good.
_W8A8_MIN_ROWS = 128


def _qmm_dispatch(x2: jnp.ndarray, q: jnp.ndarray,
                  s: jnp.ndarray, w8a8: bool) -> jnp.ndarray:
    """[M, K] x int8 [K, N] * s [N] -> [M, N] f32.

    With ``w8a8`` and M >= _W8A8_MIN_ROWS: per-row dynamic activation
    quant and an int8 x int8 -> int32 dot.  Otherwise the weight is
    dequantized and multiplied in the activation dtype."""
    if w8a8 and x2.shape[0] >= _W8A8_MIN_ROWS:
        xf = x2.astype(jnp.float32)
        a = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True),
                        1e-8) / 127.0
        qx = jnp.round(xf / a).astype(jnp.int8)
        y = jax.lax.dot_general(qx, q, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
        return y.astype(jnp.float32) * a * s[None, :].astype(jnp.float32)
    # f32 dequant then one round to the activation dtype (matches
    # dequantize_weight(leaf, x.dtype) — rounding s first shifts
    # weights ~1 ulp and flips near-tie argmaxes)
    w = (q.astype(jnp.float32) * s[None, :]).astype(x2.dtype)
    return jnp.dot(x2, w, preferred_element_type=jnp.float32)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _qmm_core(x2, q, s, w8a8):
    return _qmm_dispatch(x2, q, s, w8a8)


def _qmm_fwd(x2, q, s, w8a8):
    # zero-size sentinel carries x2's dtype (raw dtypes aren't JAX types)
    return _qmm_dispatch(x2, q, s, w8a8), (q, s, jnp.zeros((0,), x2.dtype))


def _qmm_bwd(w8a8, res, g):
    """dx = g @ (q*s)^T computed as (g*s) @ q^T in bf16/f32-accum.

    One rule covers both forward dispatches (dequant dot, W8A8
    act-quant — straight-through for the round()).  Quantized
    weights are frozen by construction, so q (int8) gets a float0
    cotangent and the scale gets zeros (training the scales is
    unsupported).  The backward dot runs in bf16 even for f32
    cotangents — intentional: dx flows through a tower that was itself
    int8-rounded in the forward, so bf16 mantissa loss is far below the
    quantization noise floor, and an f32 dot would be ~8x slower."""
    q, s, xdt = res
    gs = (g.astype(jnp.float32) * s[None, :].astype(jnp.float32)
          ).astype(jnp.bfloat16)
    dx = jnp.dot(gs, q.T.astype(jnp.bfloat16),
                 preferred_element_type=jnp.float32).astype(xdt.dtype)
    return dx, np.zeros(q.shape, jax.dtypes.float0), jnp.zeros_like(s)


_qmm_core.defvjp(_qmm_fwd, _qmm_bwd)


def quant_matmul(x: jnp.ndarray, leaf: QuantLeaf,
                 out_dtype=None, w8a8: bool = False) -> jnp.ndarray:
    """x: [..., K] bf16/f32; leaf: int8 [K, N] + scale [N] -> [..., N].

    Differentiable w.r.t. ``x`` on every dispatch path (custom VJP —
    required for training through frozen quantized towers, where
    activation gradients flow but weight gradients don't).

    w8a8: let matmuls of at least ``_W8A8_MIN_ROWS`` rows use per-row
    dynamic activation quant and an int8 dot.  Off by default: on the
    8B flagship it moves greedy tokens off the weight-only model's
    argmax (PERF.md, PR 1), so it stays opt-in until a real-weight
    accuracy gate admits it."""
    orig_shape = x.shape
    K = orig_shape[-1]
    N = leaf["q"].shape[1]
    out = _qmm_core(x.reshape(-1, K), leaf["q"], leaf["s"], bool(w8a8))
    return out.reshape(*orig_shape[:-1], N).astype(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# Activation-dynamic int8 matmul for compute-bound (big-M) paths
# ---------------------------------------------------------------------------


def int8_act_matmul(x: jnp.ndarray, leaf: QuantLeaf,
                    bias=None) -> jnp.ndarray:
    """Per-row dynamic activation quant + int8 x int8 dot + f32 dequant.

    For compute-bound matmuls (the frozen encoder at large M), where the
    int8 tensor cores run at twice the bf16 rate.  Decode-shaped
    (bandwidth-bound) matmuls use :func:`quant_matmul` — there the win is
    weight bytes, not FLOPs.
    """
    K = x.shape[-1]
    xf = x.reshape(-1, K).astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True),
                    1e-8) / 127.0
    q = jnp.round(xf / s).astype(jnp.int8)
    y = jax.lax.dot_general(q, leaf["q"], (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    y = y.astype(jnp.float32) * s * leaf["s"][None, :]
    if bias is not None:
        y = y + bias.astype(jnp.float32)
    return y.reshape(*x.shape[:-1], leaf["q"].shape[1]).astype(x.dtype)


def quantize_linear(p: Dict[str, Any]) -> Dict[str, Any]:
    """{"w", "b"?} linear params -> {"q", "s", "b"?} consumed by
    ops.core.linear's int8 dispatch."""
    out: Dict[str, Any] = dict(quantize_weight(p["w"]))
    if "b" in p:
        out["b"] = p["b"]
    return out


def _quantize_stacked_linear(p: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = dict(jax.vmap(quantize_weight)(p["w"]))
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_encoder_params(params: Dict[str, Any],
                            attention: str = "int8") -> Dict[str, Any]:
    """Quantize the whisper encoder's matmul weights (FFN fc1/fc2 and,
    with ``attention="int8"``, the attention q/k/v/o projections) to
    int8, batched over the stacked layer axis; ``attention="none"`` keeps
    the attention projections in their float dtype.

    Conv stem, positional table, and LayerNorms stay bf16 (tiny).  The
    encoder is frozen in both training and inference (reference
    modeling_desta25.py:1439-1463), so this is a pure inference-speed
    option — enable with ``encoder_quant: int8`` (the inference default
    via ``encoder_quant: auto``).  ``ops.core.linear`` runs the int8
    leaves as W8A8 (:func:`int8_act_matmul`).
    """
    if attention not in ("int8", "none"):
        raise ValueError(f"attention={attention!r}")
    out = dict(params)
    layers = dict(params["layers"])
    if attention == "int8":
        attn = dict(layers["attn"])
        for k in ("q", "k", "v", "o"):
            attn[k] = _quantize_stacked_linear(attn[k])
        layers["attn"] = attn
    for k in ("fc1", "fc2"):
        layers[k] = _quantize_stacked_linear(layers[k])
    out["layers"] = layers
    return out


# ---------------------------------------------------------------------------
# Tree quantization for the LLM
# ---------------------------------------------------------------------------

_LLM_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_llm_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize the LLM's matmul weights (per layer, batched over the
    stacked layer axis) plus the lm_head.

    The embedding table stays bf16 (lookups + splice need full-quality
    vectors and gathers aren't bandwidth-bound), but tied models gain an
    explicit quantized lm_head built from embed.T so the per-step logits
    matmul — the single largest weight read at decode — goes int8."""
    out = dict(params)
    layers = dict(params["layers"])
    for key in _LLM_QUANT_KEYS:
        w = layers[key]  # [L, in, out]
        layers[key] = jax.vmap(quantize_weight)(w)
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    else:
        out["lm_head"] = quantize_weight(jnp.transpose(params["embed"]))
    return out


def quantize_orca_cross_attns(params: Dict[str, Any]) -> Dict[str, Any]:
    """Weight-only int8 for the ORCA gated cross-attention stack
    (inference-time transform, like :func:`quantize_llm_params`).

    Deep-injection decode streams every layer's q/k/v/o/gate matrices
    each step (~2.8 GB/step bf16 at the Qwen3-4B flagship) — int8 halves
    that.  ``models.orca._xattn_linear`` routes the quantized leaves
    through quant_matmul (weight-only dequant-dot).  LayerNorms and gate2
    stay full
    precision.
    Do NOT save checkpoints from a quantized tree — this is a serving
    transform, not a training state."""
    layers = dict(params["layers"])
    # gate2 stays full precision: its weight is tiny (saves ~nothing) and
    # it feeds the sigmoid gate scalar directly
    for k in ("q", "k", "v", "o", "gate1"):
        layers[k] = _quantize_stacked_linear(layers[k])
    return {**params, "layers": layers}
