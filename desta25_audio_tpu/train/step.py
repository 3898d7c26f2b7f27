"""Jit-compiled training / eval steps.

Replaces the HF ``Trainer`` compute path (desta_trainer.py:43-102): one
XLA program per step — perception, splice, frozen-LLM forward, masked CE,
aux losses, backward (grads only w.r.t. the trainable subtree), Adafactor
update.  Under a ``use_mesh`` context the same program runs data-parallel
(batch sharded on "data") and/or tensor-parallel (weights sharded on
"model"); gradient reduction is inserted by the GSPMD partitioner — the
DDP allreduce of SURVEY §2.7, for free.

Frozen-model economics (SURVEY §7 "hard parts"): the loss closes over the
frozen tower, so JAX only differentiates w.r.t. the trainable pytree —
optimizer state is connector-sized.  ``remat=True`` rematerializes each
decoder layer to cut activation memory for the full-backprop-through-
frozen-LLM path.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..config import DeSTA25Config
from ..models import llm as jllm
from ..models.perception import perception_apply
from ..models.splice import apply_splice
from .losses import (
    masked_lm_loss_chunked,
    orca_aux_losses,
    qformer_aux_losses,
    total_loss_from_dict,
)


def _forward(params: Dict[str, Any], batch: Dict[str, jnp.ndarray],
             config: DeSTA25Config, remat: bool,
             training: bool,
             pipeline_microbatches: int = 0,
             sequence_parallel: bool = False,
             ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Shared forward: returns (total_loss, metrics)."""
    llm_cfg = config.llm_config
    input_ids = batch["input_ids"]
    attention_mask = batch["attention_mask"]
    labels = batch["labels"]

    text_embeds = jllm.embed_tokens(params["llm"], input_ids)
    aux: Dict[str, jnp.ndarray] = {}
    extra_layer_fn = None
    local_tokens = None
    audio_feats = None

    mel = batch.get("mel")
    if mel is None and "audio" in batch:
        # fuse the mel frontend into the step program
        from ..audio.mel import log_mel, pad_or_trim
        enc_cfg = config.encoder_config
        wav = pad_or_trim(batch["audio"], enc_cfg.expected_mel_frames * 160)
        mel = log_mel(wav, enc_cfg.num_mel_bins, layout="btm"
                      ).astype(text_embeds.dtype)

    if mel is not None:
        audio_feats, local_tokens = perception_apply(params, mel, config)
        trans_embeds = jax.lax.stop_gradient(
            jllm.embed_tokens(params["llm"], batch["trans_ids"]))
        inputs_embeds = apply_splice(
            text_embeds, audio_feats, trans_embeds,
            batch["kind"], batch["aidx"], batch["pos"])
    else:
        inputs_embeds = text_embeds

    align_losses = None
    extra_aux_init = None
    if (config.is_orca and config.orca_deep_injection_enabled
            and "orca_cross_attns" in params and local_tokens is not None):
        from ..models.orca import make_deep_injection_fn
        if config.orca_global_cross_attn and audio_feats is not None:
            inject_tokens = jnp.concatenate([audio_feats, local_tokens],
                                            axis=1)
        else:
            inject_tokens = local_tokens
        # transcription-embedding positions come from the splice map
        trans_pos_mask = (batch["kind"] == 2).astype(jnp.int32)
        extra_layer_fn, extra_aux_init = make_deep_injection_fn(
            params["orca_cross_attns"], config, inject_tokens,
            trans_pos_mask=trans_pos_mask, training=training)

    # skip_head + chunked CE: the full [B, T, 128k] f32 logits (plus
    # their cotangent) are ~3.7 GB at flagship scale; the head +
    # log-softmax run per sequence chunk instead.
    out = jllm.llm_apply(
        params["llm"], llm_cfg,
        inputs_embeds=inputs_embeds,
        attention_mask=attention_mask,
        lora=params.get("lora"),
        lora_scale=config.lora_scale,
        lora_dropout=(config.lora_dropout if training else 0.0),
        lora_rng=batch.get("lora_rng") if training else None,
        extra_layer_fn=extra_layer_fn,
        extra_aux_init=extra_aux_init,
        remat=remat,
        return_hidden=True,
        skip_head=True,
        # GPipe pipeline parallelism over a "pipe" mesh axis (no-op
        # off-mesh; silently skipped under LoRA/ORCA deep injection —
        # those paths keep the single-stage scan)
        pipeline_microbatches=pipeline_microbatches,
        # Megatron-style sequence parallelism (seq-sharded residual
        # stream over "model"; no-op off-mesh)
        sequence_parallel=sequence_parallel,
        # training keeps the weight-only dequant forward: W8A8 act-quant
        # noise in the frozen tower would perturb the connector's
        # learning signal
        w8a8=False,
    )
    if extra_aux_init is not None:
        _, _, hidden, (align_sum, align_n) = out
        # mean per-layer alignment loss; zeroed below when no transcription
        # positions were present (prompt-only training)
        align_losses = jnp.reshape(
            align_sum / jnp.maximum(align_n, 1.0), (1,))
        align_valid = align_n > 0
    else:
        hidden = out[2]
        align_valid = None
    d = masked_lm_loss_chunked(params["llm"], llm_cfg, hidden, labels)
    metrics = {"lm_loss": d["lm_loss"], "ppl": d["ppl"],
               "n_tokens": d["n_tokens"]}

    if config.is_orca and config.connector_mode == "orca_hybrid":
        if align_losses is not None and align_valid is not None:
            align_losses = jnp.where(align_valid, align_losses, 0.0)
        aux = orca_aux_losses(config, audio_feats, local_tokens,
                              align_losses)
    elif (config.connector_mode == "qformer_1" and config.orca_enabled
          and (config.orca_ortho_diversity_weight > 0
               or config.orca_align_weight_local > 0)
          and audio_feats is not None):
        # Q-Former ablation losses (modeling_desta25.py:846-930): pooled
        # transcription / target embeddings, no-grad.  In prompt-only
        # training there is exactly one audio per sample, so the audio-token
        # batch aligns with the text batch (N == B).
        trans_mask = batch.get("trans_mask",
                               (batch["trans_ids"] != 0).astype(jnp.int32))
        trans_pooled = jax.lax.stop_gradient(_masked_mean(
            jllm.embed_tokens(params["llm"], batch["trans_ids"]),
            trans_mask > 0))
        tgt_mask = labels != -100
        tgt_ids = jnp.where(tgt_mask, labels, 0)
        target_pooled = jax.lax.stop_gradient(_masked_mean(
            jllm.embed_tokens(params["llm"], tgt_ids), tgt_mask))
        n = min(audio_feats.shape[0], target_pooled.shape[0])
        aux = qformer_aux_losses(config, audio_feats[:n],
                                 trans_pooled[:n], target_pooled[:n])

    total = total_loss_from_dict(d["lm_loss"], aux)
    metrics.update(aux)
    metrics["loss"] = total
    return total, metrics


def _masked_mean(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """x: [B, T, H], mask: [B, T] -> [B, H]."""
    m = mask[..., None].astype(jnp.float32)
    return (jnp.sum(x.astype(jnp.float32) * m, axis=1)
            / jnp.maximum(jnp.sum(m, axis=1), 1.0))


def make_train_step(config: DeSTA25Config,
                    optimizer: optax.GradientTransformation,
                    remat: bool = False,
                    pipeline_microbatches: int = 0,
                    sequence_parallel: bool = False):
    """Returns jitted ``step(trainable, frozen, opt_state, batch) ->
    (trainable, opt_state, metrics)``."""

    @functools.partial(jax.jit, donate_argnums=(0, 2))
    def train_step(trainable, frozen, opt_state, batch):
        def loss_fn(tr):
            params = {**frozen, **tr}
            return _forward(params, batch, config, remat, training=True,
                            pipeline_microbatches=pipeline_microbatches,
                            sequence_parallel=sequence_parallel)

        (_, metrics), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(trainable)
        gnorm = optax.global_norm(grads)
        updates, opt_state = optimizer.update(grads, opt_state, trainable)
        trainable = optax.apply_updates(trainable, updates)
        metrics["grad_norm"] = gnorm
        return trainable, opt_state, metrics

    return train_step


def make_eval_step(config: DeSTA25Config, remat: bool = False,
                   pipeline_microbatches: int = 0,
                   sequence_parallel: bool = False):
    """Returns jitted ``eval_step(params, batch) -> metrics`` (loss/ppl)."""

    @jax.jit
    def eval_step(params, batch):
        _, metrics = _forward(params, batch, config, remat, training=False,
                              pipeline_microbatches=pipeline_microbatches,
                              sequence_parallel=sequence_parallel)
        return metrics

    return eval_step
