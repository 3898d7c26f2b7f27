"""Attention dispatch for every cache-less attention in the model.

One entry point serves Whisper encoder self-attention, Q-Former self- and
cross-attention (Tq=64 queries over Tkv=1500 encoder frames) and LLM
prefill/training (causal, grouped-query).  Cached decode attends over its
KV cache in ``models/llm.py`` and does not come here.

``mha`` calls ``jax.nn.dot_product_attention``.  :func:`implementation`
picks cuDNN's fused flash attention wherever cuDNN takes the call, which
keeps the [B, H, Tq, Tk] scores out of device memory, and XLA's own
softmax(QK^T)V everywhere else.  The choice is a fixed rule over what the
caller passes; nothing is tried and retried.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def implementation(platform: str, dtype, head_dim: int, tq: int, tk: int,
                   masked: bool) -> str:
    """"cudnn" or "xla" for one attention call.

    cuDNN's flash attention needs the GPU, bf16/fp16 operands and a head
    dim that is a multiple of 8 up to 256 (Hopper).  A padding mask
    reaches cuDNN as an additive [B, 1, Tq, Tk] bias, and cuDNN's backward
    pass refuses a bias over odd sequence lengths, so a masked call with
    an odd Tq or Tk takes XLA.
    """
    if platform != "gpu":
        return "xla"
    if jnp.dtype(dtype) not in (jnp.dtype(jnp.bfloat16),
                                jnp.dtype(jnp.float16)):
        return "xla"
    if head_dim % 8 or head_dim > 256:
        return "xla"
    if masked and (tq % 2 or tk % 2):
        return "xla"
    return "cudnn"


def mha(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray, *,
        kv_mask: Optional[jnp.ndarray] = None,
        causal: bool = False,
        scale: Optional[float] = None) -> jnp.ndarray:
    """Multi-head attention without a KV cache.

    q: [B, Tq, H, D]; k/v: [B, Tk, Hkv, D] with H % Hkv == 0 (GQA).
    kv_mask: optional [B, Tk] 1/0 key mask (left or right padding).
    causal: query i attends keys <= i (Tq == Tk).
    Returns [B, Tq, H, D] in q's dtype.
    """
    B, Tq, _, D = q.shape
    Tk = k.shape[1]
    mask = None
    if kv_mask is not None:
        mask = jnp.broadcast_to(kv_mask[:, None, None, :] > 0,
                                (B, 1, Tq, Tk))
    impl = implementation(jax.default_backend(), q.dtype, D, Tq, Tk,
                          mask is not None)
    out = jax.nn.dot_product_attention(
        q, k.astype(q.dtype), v.astype(q.dtype), mask=mask, scale=scale,
        is_causal=causal, implementation=impl)
    return out.astype(q.dtype)
