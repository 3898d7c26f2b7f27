"""Flagship-scale training-step setup for benchmarks and chip smoke runs.

Builds the full DeSTA2.5 training step at reference-flagship scale
(whisper-large-v3 encoder + Llama-3.1-8B backbone + 6-layer Q-Former,
desta25_llama31-8B_Qformer6L.yaml: per-device batch 12, max_seq_length
300, adafactor) on one card.

The frozen towers are bf16, as in the reference; the trainable connector
is f32.  Random weights — throughput and memory behavior only.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import DeSTA25Config


def flagship_config(connector_mode: str = "qformer_1",
                    **overrides) -> DeSTA25Config:
    """The reference flagship of ``connector_mode``; ``overrides`` are
    further DeSTA25Config fields (e.g. the depth cuts)."""
    # desta25_llama31-8B_Qformer6L.yaml
    kw = dict(llm_model_id="DeSTA-ntu/Llama-3.1-8B-Instruct",
              qformer_num_hidden_layers=6)
    if connector_mode == "orca_hybrid":
        # desta25_qwen3-4b_ORCAHybrid.yaml — the reference's ORCA
        # flagship runs on Qwen3-4B, not the 8B
        kw = dict(llm_model_id="Qwen/Qwen3-4B-Instruct-2507",
                  qformer_num_hidden_layers=2,
                  orca_global_num_tokens=64, orca_local_downsample=4,
                  orca_local_kernel_size=5, orca_audio_position_scale=2.5,
                  orca_gate_init=0.1, orca_ortho_diversity_weight=0.05,
                  orca_ortho_weight_qformer_local=0.05,
                  placeholder_token="<|video_pad|>")
    kw.update(overrides)
    return DeSTA25Config(
        encoder_model_id="openai/whisper-large-v3",
        connector_mode=connector_mode, prompt_size=64, dtype="bfloat16",
        **kw)


def build_flagship_train_setup(batch_size: int = 12, seq_len: int = 300,
                               seed: int = 0, warmup_steps: int = 100,
                               connector_mode: str = "qformer_1"):
    """Returns (cfg, step_fn, trainable, frozen, opt_state, batch) at the
    reference flagship geometry.

    connector_mode="orca_hybrid" builds the ORCA flagship instead
    (hybrid connector + per-LLM-layer gated cross-attention deep
    injection — changes the remat economics)."""
    return build_train_setup(flagship_config(connector_mode), batch_size,
                             seq_len, seed, warmup_steps)


def build_train_setup(cfg: DeSTA25Config, batch_size: int, seq_len: int,
                      seed: int = 0, warmup_steps: int = 100):
    """Random-weight train step for ``cfg`` (connector trainable, towers
    frozen): (cfg, step_fn, trainable, frozen, opt_state, batch)."""
    from ..models import llm as jllm
    from ..models import whisper as jw
    from ..models.qformer import init_qformer_connector
    from ..train.optimizer import OptimizerConfig, make_optimizer
    from ..train.step import make_train_step
    from ..utils.fast_init import random_tree_like

    llm_cfg = cfg.llm_config
    enc_cfg = cfg.encoder_config

    kq, ke, kc = jax.random.split(jax.random.PRNGKey(seed), 3)
    llm_p = random_tree_like(
        kq, lambda k: jllm.init_llm(k, llm_cfg, dtype=jnp.bfloat16),
        scale=0.02)
    eshape = jax.eval_shape(
        lambda k: jw.init_whisper_encoder(k, enc_cfg, dtype=jnp.bfloat16),
        ke)
    enc_p = random_tree_like(ke, lambda k: eshape, scale=0.02)
    if cfg.connector_mode == "orca_hybrid":
        from ..models.orca import init_orca_connector, init_orca_cross_attns
        conn_p = random_tree_like(
            kc, lambda k: init_orca_connector(k, cfg, dtype=jnp.float32),
            scale=0.02)
        xattn_p = random_tree_like(
            kc, lambda k: init_orca_cross_attns(
                k, cfg, dtype=jnp.dtype(cfg.orca_xattn_dtype)),
            scale=0.02)
        trainable: Dict[str, Any] = {"connector": conn_p,
                                     "orca_cross_attns": xattn_p}
    else:
        conn_p = random_tree_like(
            kc, lambda k: init_qformer_connector(k, cfg,
                                                 dtype=jnp.float32),
            scale=0.02)
        trainable = {"connector": conn_p}
    # only the encoder half of whisper participates in training
    frozen: Dict[str, Any] = {"llm": llm_p, "whisper": {"encoder": enc_p}}

    optimizer = make_optimizer(OptimizerConfig(
        lr=1e-4, warmup_steps=warmup_steps, total_steps=10_000))
    opt_state = optimizer.init(trainable)
    step = make_train_step(cfg, optimizer, remat=True)
    batch = synth_train_batch(cfg, batch_size, seq_len, seed=seed)
    return cfg, step, trainable, frozen, opt_state, batch


def synth_train_batch(cfg: DeSTA25Config, B: int, L: int,
                      seed: int = 0) -> Dict[str, jnp.ndarray]:
    """Collate-shaped synthetic batch (one audio per row, reference
    prompt-only layout: K audio tokens spliced at offset 4, answer region
    in the second half)."""
    rng = np.random.default_rng(seed)
    K = cfg.audio_token_size
    vocab = cfg.llm_config.vocab_size
    ids = rng.integers(10, vocab - 10, size=(B, L)).astype(np.int32)
    labels = ids.copy()
    labels[:, :L // 2] = -100
    kind = np.zeros((B, L), np.int32)
    kind[:, 4:4 + K] = 1
    aidx = np.zeros((B, L), np.int32)
    for b in range(B):
        aidx[b, 4:4 + K] = b
    pos = np.zeros((B, L), np.int32)
    pos[:, 4:4 + K] = np.arange(K)
    n_samples = cfg.encoder_config.expected_mel_frames * 160
    return {
        "input_ids": jnp.asarray(ids),
        "attention_mask": jnp.ones((B, L), jnp.int32),
        "labels": jnp.asarray(labels),
        "audio": jnp.asarray(
            (0.1 * rng.standard_normal((B, n_samples))).astype(np.float32)),
        "trans_ids": jnp.zeros((B, 8), jnp.int32),
        "trans_mask": jnp.zeros((B, 8), jnp.int32),
        "kind": jnp.asarray(kind),
        "aidx": jnp.asarray(aidx),
        "pos": jnp.asarray(pos),
    }


def hbm_analysis(step, trainable, frozen, opt_state, batch) -> Dict[str, float]:
    """Compiled-program memory analysis (GB)."""
    try:
        ma = step.lower(trainable, frozen, opt_state,
                        batch).compile().memory_analysis()
        g = 1024 ** 3
        return {
            "argument_gb": round(ma.argument_size_in_bytes / g, 2),
            "temp_gb": round(ma.temp_size_in_bytes / g, 2),
            "output_gb": round(ma.output_size_in_bytes / g, 2),
        }
    except Exception as e:  # noqa: BLE001 - backend-dependent API
        return {"error": f"{type(e).__name__}: {e}"[:120]}
