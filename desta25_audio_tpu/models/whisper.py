"""Whisper encoder + decoder in functional JAX.

Reimplements the parts of HF ``WhisperForConditionalGeneration`` the
reference uses:

- the encoder forward with intermediate layer taps
  (``WhisperPerception.forward_whisper``, modeling_desta25.py:544-627):
  conv1 -> gelu -> conv2(stride 2) -> gelu -> +sinusoidal positions ->
  pre-LN transformer layers -> (tapped hidden states), final LayerNorm only
  for the ASR path (the connector consumes pre-final-LN layer outputs);
- the decoder for ASR-in-the-loop greedy transcription
  (modeling_desta25.py:1581-1601): causal self-attn + cross-attn to the
  encoder output, learned positions, tied output embedding.

All encoder layers run under one ``lax.scan`` over stacked layer
parameters; target-layer taps are accumulated into a fixed
[n_taps, B, T, D] carry (no L-sized activation stash).  Mel input is NWC
([B, T, n_mels]), the layout the convs take without transposes.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import WhisperConfig
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
    normal_init,
    stack_layers,
)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Whisper sinusoid table (matches openai/HF ``sinusoids``)."""
    log_timescale = math.log(10000.0) / (dim // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)],
                          axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_attn(key, d: int, dtype) -> Params:
    kq, kk, kv, ko = jax.random.split(key, 4)
    return {
        "q": init_linear(kq, d, d, use_bias=True, dtype=dtype),
        "k": init_linear(kk, d, d, use_bias=False, dtype=dtype),
        "v": init_linear(kv, d, d, use_bias=True, dtype=dtype),
        "o": init_linear(ko, d, d, use_bias=True, dtype=dtype),
    }


def _init_enc_layer(key, cfg: WhisperConfig, dtype) -> Params:
    ka, k1, k2 = jax.random.split(key, 3)
    d = cfg.d_model
    return {
        "ln1": init_layer_norm(d, dtype),
        "attn": _init_attn(ka, d, dtype),
        "ln2": init_layer_norm(d, dtype),
        "fc1": init_linear(k1, d, cfg.encoder_ffn_dim, dtype=dtype),
        "fc2": init_linear(k2, cfg.encoder_ffn_dim, d, dtype=dtype),
    }


def init_whisper_encoder(key, cfg: WhisperConfig,
                         dtype=jnp.float32) -> Params:
    kc1, kc2, *lkeys = jax.random.split(key, 2 + cfg.encoder_layers)
    d = cfg.d_model
    layers = [_init_enc_layer(k, cfg, dtype) for k in lkeys]
    return {
        "conv1": init_conv1d(kc1, cfg.num_mel_bins, d, 3, dtype),
        "conv2": init_conv1d(kc2, d, d, 3, dtype),
        "embed_positions": jnp.asarray(
            sinusoidal_positions(cfg.max_source_positions, d), dtype),
        "layers": stack_layers(layers),
        "ln_post": init_layer_norm(d, dtype),
    }


def _init_dec_layer(key, cfg: WhisperConfig, dtype) -> Params:
    ka, kx, k1, k2 = jax.random.split(key, 4)
    d = cfg.d_model
    return {
        "ln1": init_layer_norm(d, dtype),
        "self_attn": _init_attn(ka, d, dtype),
        "ln_x": init_layer_norm(d, dtype),
        "cross_attn": _init_attn(kx, d, dtype),
        "ln2": init_layer_norm(d, dtype),
        "fc1": init_linear(k1, d, cfg.decoder_ffn_dim, dtype=dtype),
        "fc2": init_linear(k2, cfg.decoder_ffn_dim, d, dtype=dtype),
    }


def init_whisper_decoder(key, cfg: WhisperConfig,
                         dtype=jnp.float32) -> Params:
    ke, kp, *lkeys = jax.random.split(key, 2 + cfg.decoder_layers)
    d = cfg.d_model
    layers = [_init_dec_layer(k, cfg, dtype) for k in lkeys]
    return {
        "embed_tokens": normal_init(ke, (cfg.vocab_size, d), 0.02, dtype),
        "embed_positions": normal_init(kp, (cfg.max_target_positions, d),
                                       0.02, dtype),
        "layers": stack_layers(layers),
        "ln": init_layer_norm(d, dtype),
    }


def init_whisper(key, cfg: WhisperConfig, dtype=jnp.float32) -> Params:
    k1, k2 = jax.random.split(key)
    return {
        "encoder": init_whisper_encoder(k1, cfg, dtype),
        "decoder": init_whisper_decoder(k2, cfg, dtype),
    }


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _split_heads(x: jnp.ndarray, n_heads: int) -> jnp.ndarray:
    B, T, D = x.shape
    return x.reshape(B, T, n_heads, D // n_heads)


def _merge_heads(x: jnp.ndarray) -> jnp.ndarray:
    B, T, H, Dh = x.shape
    return x.reshape(B, T, H * Dh)


def _enc_self_attn(p: Params, x: jnp.ndarray, n_heads: int) -> jnp.ndarray:
    """Bidirectional encoder self-attention (no mask: every clip is padded
    to Whisper's fixed 30 s window)."""
    from ..ops.attention import mha
    q = _split_heads(linear(p["q"], x), n_heads)
    k = _split_heads(linear(p["k"], x), n_heads)
    v = _split_heads(linear(p["v"], x), n_heads)
    return linear(p["o"], _merge_heads(mha(q, k, v)))


def _enc_layer_apply(p: Params, x: jnp.ndarray, n_heads: int) -> jnp.ndarray:
    x = x + _enc_self_attn(p["attn"], layer_norm(p["ln1"], x), n_heads)
    h = layer_norm(p["ln2"], x)
    return x + linear(p["fc2"], gelu(linear(p["fc1"], h)))


def whisper_encoder_apply(
    params: Params,
    mel: jnp.ndarray,
    cfg: WhisperConfig,
    target_layer_ids: Tuple[int, ...] = (),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run the encoder.

    mel: [B, 3000, n_mels] (NWC).
    Returns (final_hidden [B, 1500, D] — post final LayerNorm, for the ASR
    cross-attention) and taps [n_taps, B, 1500, D] — the hidden state
    *after* each target layer, pre-final-LN, matching the reference's
    inline connector inputs (modeling_desta25.py:575-598).
    """
    if mel.shape[1] != cfg.expected_mel_frames:
        raise ValueError(
            f"Whisper expects mel length {cfg.expected_mel_frames}, got "
            f"{mel.shape[1]}; pad/truncate the features first."
        )
    x = gelu(conv1d(params["conv1"], mel, stride=1, padding=1))
    x = gelu(conv1d(params["conv2"], x, stride=2, padding=1))
    x = x + params["embed_positions"][None, :x.shape[1]].astype(x.dtype)

    def body(hidden, p):
        return _enc_layer_apply(p, hidden,
                                cfg.encoder_attention_heads), None

    n_taps = len(target_layer_ids)
    if not n_taps:
        x, _ = jax.lax.scan(body, x, params["layers"])
        B, T, D = x.shape
        taps = jnp.zeros((1, B, T, D), x.dtype)
    else:
        # One scan over all layers; EVERY layer writes its hidden state
        # into a [n_taps + 1, B, T, D] carry — tap layers into their
        # slot, the other layers into a dead scratch slot.  The
        # unconditional dynamic_update_slice keeps the carry in place and
        # the scan body free of control flow.
        assert list(target_layer_ids) == sorted(set(target_layer_ids)), \
            target_layer_ids
        tap_arr = jnp.asarray(target_layer_ids)

        def body_tap(carry, p_i):
            hidden, taps = carry
            p, i = p_i
            h = _enc_layer_apply(p, hidden, cfg.encoder_attention_heads)
            hit = tap_arr == i
            slot = jnp.where(jnp.any(hit), jnp.argmax(hit), n_taps)
            taps = jax.lax.dynamic_update_slice(
                taps, h[None], (slot, 0, 0, 0))
            return (h, taps), None

        taps0 = jnp.zeros((n_taps + 1,) + x.shape, x.dtype)
        (x, taps), _ = jax.lax.scan(
            body_tap, (x, taps0),
            (params["layers"], jnp.arange(cfg.encoder_layers)))
        taps = taps[:n_taps]
    final = layer_norm(params["ln_post"], x)
    return final, taps


def _dec_layer_apply(p: Params, x: jnp.ndarray, enc_kv, n_heads: int,
                     self_mask, cache=None, cache_index=None):
    """One decoder layer. enc_kv: precomputed (k, v) from encoder output.

    cache: optional (k, v) for self-attn, each [B, Tmax, H, Dh]; returns
    updated cache.  With a cache, x is the new suffix [B, Ts, D] written at
    ``cache_index``.
    """
    h = layer_norm(p["ln1"], x)
    q = _split_heads(linear(p["self_attn"]["q"], h), n_heads)
    k = _split_heads(linear(p["self_attn"]["k"], h), n_heads)
    v = _split_heads(linear(p["self_attn"]["v"], h), n_heads)
    if cache is not None:
        ck, cv = cache
        ck = jax.lax.dynamic_update_slice(ck, k.astype(ck.dtype),
                                          (0, cache_index, 0, 0))
        cv = jax.lax.dynamic_update_slice(cv, v.astype(cv.dtype),
                                          (0, cache_index, 0, 0))
        k, v = ck, cv
        cache = (ck, cv)
    attn = mha(q, k, v, mask=self_mask)
    x = x + linear(p["self_attn"]["o"], _merge_heads(attn))

    h = layer_norm(p["ln_x"], x)
    qx = _split_heads(linear(p["cross_attn"]["q"], h), n_heads)
    ek, ev = enc_kv
    attn = mha(qx, ek, ev, mask=None)
    x = x + linear(p["cross_attn"]["o"], _merge_heads(attn))

    h = layer_norm(p["ln2"], x)
    x = x + linear(p["fc2"], gelu(linear(p["fc1"], h)))
    return x, cache


def whisper_cross_kv(params: Params, enc_out: jnp.ndarray,
                     cfg: WhisperConfig) -> Params:
    """Precompute per-layer cross-attention K/V from the encoder output.
    Returns stacked (k, v): each [L, B, T_enc, H, Dh]."""
    H = cfg.decoder_attention_heads

    def per_layer(p):
        k = _split_heads(linear(p["cross_attn"]["k"], enc_out), H)
        v = _split_heads(linear(p["cross_attn"]["v"], enc_out), H)
        return k, v

    return jax.vmap(per_layer)(params["layers"])


def whisper_decoder_apply(
    params: Params,
    tokens: jnp.ndarray,
    cross_kv,
    cfg: WhisperConfig,
    pos_offset: int | jnp.ndarray = 0,
    cache=None,
    cache_index=None,
):
    """Decoder forward.

    tokens: [B, T] int32.  cross_kv: from :func:`whisper_cross_kv`.
    Without a cache: full causal self-attention over ``tokens``.
    With cache=(k [L,B,Tmax,H,Dh], v): append-at-``cache_index`` decode.
    Returns (logits [B, T, V], new_cache).
    """
    H = cfg.decoder_attention_heads
    B, T = tokens.shape
    x = params["embed_tokens"][tokens]
    positions = pos_offset + jnp.arange(T)
    x = x + params["embed_positions"][positions][None].astype(x.dtype)

    if cache is None:
        mask = jnp.tril(jnp.ones((T, T), bool))[None, None]
        new_cache = None

        def body(h, inp):
            p, ckv = inp
            h, _ = _dec_layer_apply(p, h, ckv, H, mask)
            return h, None

        x, _ = jax.lax.scan(body, x, (params["layers"], cross_kv))
    else:
        Tmax = cache[0].shape[2]
        key_pos = jnp.arange(Tmax)[None, None, None, :]
        q_pos = (cache_index + jnp.arange(T))[None, None, :, None]
        mask = key_pos <= q_pos  # causal within the appended suffix too

        def body(h, inp):
            p, ckv, ck, cv = inp
            h, (nk, nv) = _dec_layer_apply(p, h, ckv, H, mask, (ck, cv),
                                           cache_index)
            return h, (nk, nv)

        x, new_cache = jax.lax.scan(
            body, x, (params["layers"], cross_kv, cache[0], cache[1]))

    x = layer_norm(params["ln"], x)
    logits = jnp.einsum("btd,vd->btv", x, params["embed_tokens"],
                        preferred_element_type=jnp.float32)
    return logits, new_cache


def init_decoder_cache(cfg: WhisperConfig, batch: int, max_len: int,
                       dtype=jnp.bfloat16):
    H = cfg.decoder_attention_heads
    Dh = cfg.d_model // H
    shape = (cfg.decoder_layers, batch, max_len, H, Dh)
    return (jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))
