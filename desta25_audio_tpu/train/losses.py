"""Training losses.

- Masked next-token cross-entropy with HF label semantics (-100 = ignored,
  internal shift-by-one), matching what the reference gets from
  ``llm_model(inputs_embeds=..., labels=...)`` (modeling_desta25.py:811).
- Q-Former ablation losses (diversity + margin-contrastive alignment,
  modeling_desta25.py:1208-1282).
- ORCA auxiliary losses (diversity, global-local orthogonality, layer-wise
  alignment, modeling_desta25.py:1159-1206).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..config import DeSTA25Config

IGNORE_INDEX = -100


def masked_lm_loss(logits: jnp.ndarray, labels: jnp.ndarray
                   ) -> Dict[str, jnp.ndarray]:
    """logits [B, T, V] (float32), labels [B, T] with -100 masking.
    Shift-by-one next-token CE; returns {"lm_loss", "n_tokens", "ppl"}."""
    logits = logits[:, :-1].astype(jnp.float32)
    targets = labels[:, 1:]
    mask = targets != IGNORE_INDEX
    safe_targets = jnp.where(mask, targets, 0)
    logp = jax.nn.log_softmax(logits, axis=-1)
    token_logp = jnp.take_along_axis(
        logp, safe_targets[..., None], axis=-1)[..., 0]
    n = jnp.maximum(jnp.sum(mask), 1)
    loss = -jnp.sum(jnp.where(mask, token_logp, 0.0)) / n
    return {"lm_loss": loss, "n_tokens": n, "ppl": jnp.exp(loss)}


def masked_lm_loss_chunked(llm_params, llm_cfg, hidden: jnp.ndarray,
                           labels: jnp.ndarray,
                           chunk: int = 64) -> Dict[str, jnp.ndarray]:
    """Same CE as :func:`masked_lm_loss` WITHOUT materializing the full
    [B, T, V] logits.

    At flagship training scale (B=12, T=300, V=128k) full f32 logits are
    1.84 GB, plus their gradient, for nothing the loss needs.
    This variant scans the LM head + log-softmax over ``chunk``-token
    slices of the (shifted) sequence under ``jax.checkpoint``: forward
    and backward only ever hold one chunk's logits (~100-400 MB).  The
    summed result is numerically the same loss (per-chunk partial sums).

    hidden: [B, T, D] pre-logits (llm_apply(skip_head=True)); labels
    [B, T] with -100 ignore positions.
    """
    from ..models.llm import _head_logits

    hidden = hidden[:, :-1]
    targets = labels[:, 1:]
    B, T, D = hidden.shape
    Tp = -(-T // chunk) * chunk
    if Tp != T:
        hidden = jnp.pad(hidden, ((0, 0), (0, Tp - T), (0, 0)))
        targets = jnp.pad(targets, ((0, 0), (0, Tp - T)),
                          constant_values=IGNORE_INDEX)
    n_chunks = Tp // chunk
    hc = hidden.reshape(B, n_chunks, chunk, D).transpose(1, 0, 2, 3)
    tc = targets.reshape(B, n_chunks, chunk).transpose(1, 0, 2)

    @jax.checkpoint
    def chunk_sums(h, t):
        logits = _head_logits(llm_params, llm_cfg, h,
                              w8a8=False).astype(jnp.float32)
        mask = t != IGNORE_INDEX
        safe = jnp.where(mask, t, 0)
        logp = jax.nn.log_softmax(logits, axis=-1)
        tl = jnp.take_along_axis(logp, safe[..., None], axis=-1)[..., 0]
        return (jnp.sum(jnp.where(mask, tl, 0.0)),
                jnp.sum(mask).astype(jnp.int32))

    def body(carry, xs):
        s, n = carry
        ds, dn = chunk_sums(*xs)
        return (s + ds, n + dn), None

    (s, n), _ = jax.lax.scan(
        body, (jnp.float32(0.0), jnp.int32(0)), (hc, tc))
    n = jnp.maximum(n, 1)
    loss = -s / n
    return {"lm_loss": loss, "n_tokens": n, "ppl": jnp.exp(loss)}


def _normalize(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    # sqrt(sum(x^2) + eps^2) instead of linalg.norm + eps: norm's
    # backward at x == 0 is 0/0 = NaN (see models/orca.py _l2norm).
    sq = jnp.sum(jnp.square(x), axis=axis, keepdims=True)
    return x * jax.lax.rsqrt(sq + 1e-12)


def diversity_loss(tokens: jnp.ndarray) -> jnp.ndarray:
    """‖GᵀG − I‖² over normalized tokens [B, K, H]
    (modeling_desta25.py:1175-1181)."""
    g = _normalize(tokens.astype(jnp.float32))
    gram = jnp.einsum("bkh,bqh->bkq", g, g)
    eye = jnp.eye(gram.shape[-1])
    return jnp.mean((gram - eye[None]) ** 2)


def global_local_ortho_loss(global_tokens: jnp.ndarray,
                            local_tokens: jnp.ndarray,
                            max_local: int = 100) -> jnp.ndarray:
    """Mean squared global x local cross-similarity with uniform local
    sampling to <=100 tokens (modeling_desta25.py:1183-1198)."""
    g = _normalize(global_tokens.astype(jnp.float32))
    l = _normalize(local_tokens.astype(jnp.float32))
    Tl = l.shape[1]
    if Tl > max_local:
        idx = jnp.linspace(0, Tl - 1, max_local).astype(jnp.int32)
        l = l[:, idx]
    cross = jnp.einsum("bgh,blh->bgl", g, l)
    return jnp.mean(cross ** 2)


def qformer_aux_losses(
    config: DeSTA25Config,
    qformer_tokens: Optional[jnp.ndarray],       # [B, K, H] pooled
    transcription_embeds: Optional[jnp.ndarray],  # [B, H]
    target_embeds: Optional[jnp.ndarray],         # [B, H]
) -> Dict[str, jnp.ndarray]:
    """Q-Former ablation losses (reference compute_qformer_losses).
    Only called when config.orca_enabled and a weight > 0."""
    losses: Dict[str, jnp.ndarray] = {}
    if qformer_tokens is not None and config.orca_ortho_diversity_weight > 0:
        losses["L_ortho_diversity"] = (
            config.orca_ortho_diversity_weight
            * diversity_loss(qformer_tokens))
    if (qformer_tokens is not None and config.orca_align_weight_local > 0
            and transcription_embeds is not None
            and target_embeds is not None):
        audio_pooled = _normalize(
            jnp.mean(qformer_tokens.astype(jnp.float32), axis=1))
        trans_pooled = _normalize(transcription_embeds.astype(jnp.float32))
        target_pooled = _normalize(target_embeds.astype(jnp.float32))
        sim_trans = jnp.sum(audio_pooled * trans_pooled, axis=-1)
        sim_target = jnp.sum(audio_pooled * target_pooled, axis=-1)
        margin = 0.5
        contrastive = jnp.mean(
            jnp.clip(margin + sim_trans - sim_target, a_min=0.0))
        target_align = jnp.mean(1.0 - sim_target)
        losses["L_align"] = (config.orca_align_weight_local
                             * (contrastive + 0.5 * target_align))
        losses["L_align_contrastive"] = contrastive
        losses["L_align_target"] = target_align
        losses["sim_trans"] = jnp.mean(sim_trans)
        losses["sim_target"] = jnp.mean(sim_target)
    return losses


def orca_aux_losses(
    config: DeSTA25Config,
    global_tokens: Optional[jnp.ndarray],
    local_tokens: Optional[jnp.ndarray],
    layer_align_losses: Optional[jnp.ndarray],  # [n_layers] or None
) -> Dict[str, jnp.ndarray]:
    """ORCA losses (reference compute_orca_losses)."""
    losses: Dict[str, jnp.ndarray] = {}
    if global_tokens is not None:
        losses["L_ortho_diversity"] = (
            config.orca_ortho_diversity_weight
            * diversity_loss(global_tokens))
    if global_tokens is not None and local_tokens is not None:
        losses["L_ortho_qformer_local"] = (
            config.orca_ortho_weight_qformer_local
            * global_local_ortho_loss(global_tokens, local_tokens))
    if layer_align_losses is not None:
        losses["L_align_layerwise"] = (
            config.orca_align_weight_local * jnp.mean(layer_align_losses))
    return losses


def total_loss_from_dict(lm_loss: jnp.ndarray,
                         aux: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    """total = lm + Σ weighted aux terms (monitoring-only keys excluded),
    matching DeSTA25Trainer.compute_loss (desta_trainer.py:56-100)."""
    total = lm_loss
    for k, v in aux.items():
        if k.startswith("L_") and k not in ("L_align_contrastive",
                                            "L_align_target"):
            total = total + v
    return total
