"""KV-cached autoregressive decoding loops (LLM + Whisper ASR).

Replaces HF ``generate`` (modeling_desta25.py:1419-1427 for the LLM,
:1586-1594 for Whisper ASR) with jit-compiled ``lax.while_loop`` decode:
static shapes, preallocated caches, early exit when every row has emitted a
stop token.  Sampling supports greedy / temperature / nucleus (top-p),
matching the reference's generation kwargs surface
(temperature, top_p, max_new_tokens, do_sample).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import LLMConfig, WhisperConfig
from ..models import llm as jllm
from ..models import whisper as jw

# OpenAI whisper non-speech token ids (music/annotation symbols) for the
# multilingual BPE vocab — the text-range (< 50257) portion of every HF
# whisper checkpoint's generation_config.suppress_tokens, identical across
# tiny..large-v3 (reference inherits it via whisper.generate,
# modeling_desta25.py:1586-1594).  The model-specific special-token tail
# (>= 50257: sot/language/task/timestamps) is covered by ``suppress_from``.
WHISPER_NON_SPEECH_TOKEN_IDS = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254,
)

# HF whisper generation_config.begin_suppress_tokens: the first sampled
# token may not be a bare space (220) or end-of-text.
WHISPER_BEGIN_SUPPRESS_TOKEN_IDS = (220,)


# top-p sampling runs on a top-K candidate set instead of a full-vocab
# sort over V=128k.  Probabilities stay normalized over the FULL vocab
# (logsumexp), so the nucleus cut is exact whenever it fits in 256
# candidates; beyond that the tail truncates (standard practice — vLLM
# caps top-p the same way).  approx_max_k with recall_target=0.99: misses
# concentrate on near-boundary tail candidates, negligible for sampling;
# greedy rows always use the exact full-vocab argmax.
_TOP_P_CANDIDATES = 256


def _top_p_sample(scaled: jnp.ndarray, key, top_p) -> jnp.ndarray:
    """scaled: [B, V] temperature-scaled logits; top_p [B] or scalar.
    Returns [B] sampled token ids (nucleus sampling on the candidate
    set — distribution-identical to masked full-vocab sampling when the
    nucleus fits the candidates)."""
    k = min(_TOP_P_CANDIDATES, scaled.shape[-1])
    topv, topi = jax.lax.approx_max_k(scaled, k, recall_target=0.99,
                                      aggregate_to_topk=True)
    lse = jax.nn.logsumexp(scaled, axis=-1, keepdims=True)
    probs = jnp.exp(topv - lse)
    cum = jnp.cumsum(probs, axis=-1)
    top_p = jnp.asarray(top_p, scaled.dtype)
    tp = top_p[..., None] if top_p.ndim else top_p
    # keep tokens until cumulative prob exceeds top_p (always keep 1st)
    keep = cum - probs < tp
    masked = jnp.where(keep, topv, -jnp.inf)
    ch = jax.random.categorical(key, masked, axis=-1)
    return jnp.take_along_axis(topi, ch[..., None], -1)[..., 0].astype(
        jnp.int32)


def sample_token(logits: jnp.ndarray, key, temperature: float, top_p: float,
                 do_sample: bool) -> jnp.ndarray:
    """logits: [B, V] float32 -> [B] int32."""
    if not do_sample:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    scaled = logits / jnp.maximum(temperature, 1e-6)
    if top_p >= 1.0:
        # pure temperature sampling: full-vocab categorical (exact)
        return jax.random.categorical(key, scaled, axis=-1).astype(
            jnp.int32)
    return _top_p_sample(scaled, key, top_p)


def sample_token_dynamic(logits: jnp.ndarray, key,
                         temperature: jnp.ndarray,
                         top_p: jnp.ndarray,
                         do_sample: jnp.ndarray) -> jnp.ndarray:
    """Per-row sampling with *traced* parameters.

    logits: [B, V] float32; temperature/top_p: [B] float32;
    do_sample: [B] bool.  One compiled program serves every
    temperature/top-p combination — the serving engine mixes requests
    with different sampling settings in one decode batch.
    """
    greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    scaled = logits / jnp.maximum(temperature, 1e-6)[:, None]
    sampled = _top_p_sample(scaled, key, top_p)
    # rows asking for pure temperature sampling (top_p >= 1) get the
    # exact full-vocab categorical via Gumbel-argmax — the candidate-set
    # path would silently drop all mass beyond the top 256 tokens.  One
    # extra argmax over [B, V]; no sort.
    g = -jnp.log(-jnp.log(
        jax.random.uniform(jax.random.fold_in(key, 1), scaled.shape,
                           minval=1e-20, maxval=1.0)))
    full = jnp.argmax(scaled + g, axis=-1).astype(jnp.int32)
    sampled = jnp.where(jnp.asarray(top_p) >= 1.0, full, sampled)
    return jnp.where(do_sample, sampled, greedy)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "max_new_tokens", "temperature", "top_p",
                     "do_sample", "eos_ids", "pad_id", "inject_scale",
                     "inject_heads", "lora_scale"),
)
def llm_generate(
    params,
    cfg: LLMConfig,
    inputs_embeds: jnp.ndarray,       # [B, T, D] spliced context (left-pad)
    attention_mask: jnp.ndarray,      # [B, T] 1/0
    key: jax.Array,
    *,
    max_new_tokens: int,
    temperature: float = 1.0,
    top_p: float = 1.0,
    do_sample: bool = False,
    eos_ids: Tuple[int, ...] = (),
    pad_id: int = 0,
    lora=None,
    lora_scale: float = 1.0,
    inject_params=None,
    inject_tokens=None,
    inject_scale: float = 2.5,
    inject_heads: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Prefill + decode. Returns (tokens [B, max_new_tokens], n_generated
    [B]) where positions past the stop token hold ``pad_id``.

    inject_params/inject_tokens: optional ORCA gated cross-attention deep
    injection — applied after every decoder layer during BOTH prefill and
    decode (the reference wraps the decoder layers, so HF generate hits
    them on every step; modeling_desta25.py:1418-1434).
    """
    B, T, D = inputs_embeds.shape
    extra_layer_fn = None
    if inject_params is not None:
        from ..models.orca import (
            gated_cross_attention_apply,
            precompute_cross_kv,
        )
        from ..ops.rope import fractional_rope_apply
        roped = fractional_rope_apply(inject_tokens, inject_scale,
                                      cfg.rope_theta)
        # per-layer audio K/V are decode-loop constants: project once
        # here (outside the while_loop) instead of every step x layer
        inj_k, inj_v = precompute_cross_kv(inject_params, roped)

        def extra_layer_fn(idx, h):
            lp = jax.tree.map(lambda x: x[idx], inject_params["layers"])
            return gated_cross_attention_apply(
                lp, h, None, inject_heads,
                cached_kv=(inj_k[idx], inj_v[idx]))

    Tmax = T + max_new_tokens
    cache = jllm.init_kv_cache(cfg, B, Tmax, dtype=inputs_embeds.dtype)

    full_mask = jnp.zeros((B, Tmax), jnp.int32).at[:, :T].set(attention_mask)
    positions = jnp.maximum(jnp.cumsum(attention_mask, axis=1) - 1, 0)
    logits, cache, _ = jllm.llm_apply(
        params, cfg, inputs_embeds=inputs_embeds,
        attention_mask=full_mask, positions=positions,
        cache=cache, cache_index=0, lora=lora, lora_scale=lora_scale,
        extra_layer_fn=extra_layer_fn)
    last_pos = positions[:, -1]

    key, sub = jax.random.split(key)
    tok0 = sample_token(logits[:, -1], sub, temperature, top_p, do_sample)
    eos_arr = jnp.asarray(eos_ids, jnp.int32) if eos_ids else None

    def is_eos(t):
        if eos_arr is None:
            return jnp.zeros_like(t, dtype=bool)
        return jnp.any(t[:, None] == eos_arr[None, :], axis=-1)

    # Stop tokens stay in the output (HF semantics; decode with
    # skip_special_tokens drops them); positions after the stop hold pad_id.
    out0 = jnp.full((B, max_new_tokens), pad_id, jnp.int32)
    out0 = out0.at[:, 0].set(tok0)
    state = dict(
        t=jnp.asarray(0, jnp.int32),
        cur=tok0,
        done=is_eos(tok0),
        out=out0,
        cache=cache,
        mask=full_mask,
        pos=last_pos + 1,
        key=key,
    )

    def cond(s):
        return (s["t"] < max_new_tokens - 1) & (~jnp.all(s["done"]))

    def body(s):
        t = s["t"]
        write_idx = T + t
        mask = s["mask"].at[:, write_idx].set(1)
        logits, cache, _ = jllm.llm_apply(
            params, cfg, input_ids=s["cur"][:, None],
            attention_mask=mask, positions=s["pos"][:, None],
            cache=s["cache"], cache_index=write_idx, lora=lora,
            lora_scale=lora_scale, extra_layer_fn=extra_layer_fn)
        key, sub = jax.random.split(s["key"])
        nxt = sample_token(logits[:, -1], sub, temperature, top_p, do_sample)
        nxt = jnp.where(s["done"], pad_id, nxt)
        out = s["out"].at[:, t + 1].set(nxt)
        done = s["done"] | is_eos(nxt)
        return dict(t=t + 1, cur=nxt, done=done, out=out, cache=cache,
                    mask=mask, pos=s["pos"] + 1, key=key)

    state = jax.lax.while_loop(cond, body, state)
    n_gen = jnp.sum(state["out"] != pad_id, axis=-1)
    return state["out"], n_gen


@functools.partial(jax.jit,
                   static_argnames=("cfg", "max_new_tokens",
                                    "language_token", "suppress_ids",
                                    "suppress_from", "begin_suppress_ids",
                                    "temperature"))
def whisper_transcribe(
    params,
    cfg: WhisperConfig,
    mel: jnp.ndarray,  # [N, 3000, n_mels] NWC
    *,
    max_new_tokens: int = 128,
    language_token: Optional[int] = None,
    suppress_ids: Tuple[int, ...] = (),
    suppress_from: Optional[int] = None,
    begin_suppress_ids: Tuple[int, ...] = (),
    temperature: float = 0.0,
    key: Optional[jax.Array] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ASR decode (reference ASR-in-the-loop,
    modeling_desta25.py:1586-1594): greedy at temperature 0, multinomial
    sampling otherwise (the fallback-cascade retry tiers).

    Start sequence: <|sot|> <|lang|> <|transcribe|> <|notimestamps|>; the
    language token is detected from the first decoder step when not given
    (Whisper detect_language behavior).  ``suppress_ids`` masks Whisper's
    non-text special tokens (HF generation_config.suppress_tokens) so real
    checkpoints don't emit them under greedy decode.

    Returns (ids [N, max_new_tokens] padded with eos, avg_logprob [N]) —
    the mean log-probability of emitted tokens (EOS included, OpenAI
    whisper DecodingResult semantics) that drives the quality gate in
    :func:`whisper_transcribe_with_fallback`.
    """
    N = mel.shape[0]
    enc_out, _ = jw.whisper_encoder_apply(params["encoder"], mel, cfg)
    ckv = jw.whisper_cross_kv(params["decoder"], enc_out, cfg)

    sot = cfg.decoder_start_token_id
    # drop ids beyond the vocab (nano test vocabs) — an out-of-range
    # scatter would clamp onto the last real token
    suppress_ids = tuple(i for i in suppress_ids if i < cfg.vocab_size)
    begin_suppress_ids = tuple(i for i in begin_suppress_ids
                               if i < cfg.vocab_size)

    def suppress(lg):
        # ``suppress_from`` blanks the whole special-token block
        # (sot/language/task/timestamp ids sit at the top of the vocab);
        # ``suppress_ids`` blanks an explicit list (HF suppress_tokens).
        if suppress_from is not None:
            ids = jnp.arange(lg.shape[-1])
            keep = (ids < suppress_from) | (ids == cfg.eos_token_id)
            lg = jnp.where(keep, lg, -jnp.inf)
        if suppress_ids:
            lg = lg.at[..., jnp.asarray(suppress_ids, jnp.int32)
                       ].set(-jnp.inf)
        return lg

    if language_token is None:
        # one step from <|sot|>, argmax restricted to the language block
        lg, _ = jw.whisper_decoder_apply(
            params["decoder"], jnp.full((N, 1), sot, jnp.int32), ckv, cfg)
        lang_block = jax.lax.dynamic_slice_in_dim(
            lg[:, 0], cfg.first_language_token_id, cfg.num_language_tokens,
            axis=-1)
        lang_tok = (cfg.first_language_token_id
                    + jnp.argmax(lang_block, axis=-1).astype(jnp.int32))
    else:
        lang_tok = jnp.full((N,), language_token, jnp.int32)

    prefix = jnp.stack([
        jnp.full((N,), sot, jnp.int32),
        lang_tok,
        jnp.full((N,), cfg.transcribe_token_id, jnp.int32),
        jnp.full((N,), cfg.no_timestamps_token_id, jnp.int32),
    ], axis=1)  # [N, 4]
    P = prefix.shape[1]
    Tmax = P + max_new_tokens
    cache = jw.init_decoder_cache(cfg, N, Tmax, dtype=enc_out.dtype)
    logits, cache = jw.whisper_decoder_apply(
        params["decoder"], prefix, ckv, cfg, pos_offset=0, cache=cache,
        cache_index=0)
    eos = cfg.eos_token_id
    if temperature > 0 and key is None:
        raise ValueError("sampled ASR decode (temperature > 0) needs a key")

    def pick(lg, step, begin=False):
        """Suppressed logits [N, V] -> (token [N], logprob-of-token [N])."""
        lg = suppress(lg).astype(jnp.float32)
        if begin and begin_suppress_ids:
            # HF begin_suppress_tokens: first sampled token may not be a
            # bare space / end-of-text
            ids_ = begin_suppress_ids + (cfg.eos_token_id,)
            lg = lg.at[..., jnp.asarray(ids_, jnp.int32)].set(-jnp.inf)
        if temperature > 0:
            tok = jax.random.categorical(
                jax.random.fold_in(key, step), lg / temperature, axis=-1)
            tok = tok.astype(jnp.int32)
        else:
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        lp = jnp.take_along_axis(jax.nn.log_softmax(lg, axis=-1),
                                 tok[:, None], axis=-1)[:, 0]
        return tok, lp

    tok0, lp0 = pick(logits[:, -1], 0, begin=True)
    out0 = jnp.full((N, max_new_tokens), eos, jnp.int32).at[:, 0].set(tok0)
    state = dict(t=jnp.asarray(0, jnp.int32), cur=tok0, done=tok0 == eos,
                 out=out0, cache=cache, lp_sum=lp0,
                 n_tok=jnp.ones((N,), jnp.float32))

    def cond(s):
        return (s["t"] < max_new_tokens - 1) & (~jnp.all(s["done"]))

    def body(s):
        t = s["t"]
        lg, cache = jw.whisper_decoder_apply(
            params["decoder"], s["cur"][:, None], ckv, cfg,
            pos_offset=P + t, cache=s["cache"], cache_index=P + t)
        nxt, lp = pick(lg[:, -1], t + 1)
        nxt = jnp.where(s["done"], eos, nxt)
        live = (~s["done"]).astype(jnp.float32)
        return dict(t=t + 1, cur=nxt, done=s["done"] | (nxt == eos),
                    out=s["out"].at[:, t + 1].set(nxt), cache=cache,
                    lp_sum=s["lp_sum"] + lp * live,
                    n_tok=s["n_tok"] + live)

    state = jax.lax.while_loop(cond, body, state)
    return state["out"], state["lp_sum"] / state["n_tok"]


def compression_ratio(text: str) -> float:
    """Bytes-to-gzip ratio; > ~2.4 flags degenerate repetition loops
    (OpenAI whisper decoding.py quality gate)."""
    import zlib
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def whisper_transcribe_with_fallback(
    params,
    cfg: WhisperConfig,
    mel: jnp.ndarray,
    detokenize,
    key: Optional[jax.Array] = None,
    *,
    temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    logprob_threshold: float = -1.0,
    compression_ratio_threshold: float = 2.4,
    **kwargs,
):
    """Temperature-fallback ASR cascade (OpenAI whisper
    transcribe.py semantics; beyond the reference, whose HF
    ``whisper.generate(max_new_tokens=128)`` is a single greedy pass —
    modeling_desta25.py:1586-1594).

    Each tier decodes the FULL mel batch at one temperature (a single
    compiled program per tier, compiled only when reached — shape-stable,
    no per-subset recompiles); rows whose previous-tier result failed the
    quality gate (avg logprob below ``logprob_threshold`` or gzip
    compression ratio above ``compression_ratio_threshold``) take the new
    tier's output.  ``detokenize(ids [N, T]) -> list[str]`` supplies the
    text for the compression check.  Returns (texts, ids, avg_logprobs).
    """
    import numpy as np

    if key is None:
        key = jax.random.PRNGKey(0)
    n = mel.shape[0]
    texts: list = [None] * n
    best_ids = None
    best_lp = np.full((n,), -np.inf, np.float32)
    pending = np.arange(n)

    for ti, temp in enumerate(temperatures):
        ids, lp = whisper_transcribe(
            params, cfg, mel, temperature=float(temp),
            key=jax.random.fold_in(key, ti), **kwargs)
        ids, lp = np.asarray(ids), np.asarray(lp, np.float32)
        tier_texts = detokenize(ids)
        if best_ids is None:
            best_ids = ids.copy()
        failed = []
        for i in pending:
            texts[i] = tier_texts[i]
            best_ids[i] = ids[i]
            best_lp[i] = lp[i]
            bad = (lp[i] < logprob_threshold
                   or compression_ratio(tier_texts[i])
                   > compression_ratio_threshold)
            if bad and ti + 1 < len(temperatures):
                failed.append(i)
        pending = np.asarray(failed, int)
        if pending.size == 0:
            break
    return texts, best_ids, best_lp
