"""Speculative decoding (greedy + sampled): n-gram drafting + multi-token
verify.

Decode is bound by the weight stream, so verifying ``k`` draft tokens per
row in one T=k cached forward (``llm_apply`` with per-row cache offsets)
reads the weights once for k positions.  That makes *prompt-lookup*
speculative decoding (vLLM's ngram drafter; no draft model, no training)
cheap: propose the continuation of the last n-gram's most recent earlier
occurrence in the token history, verify all k tokens in one weight
stream, and accept the longest prefix that matches the model's own
greedy choices.  Repetitive stretches (transcriptions, lists, JSON,
quoted context) decode several tokens per step.

Acceptance semantics: each verify position j draws its token from the
model's processed next-token distribution at j (argmax when greedy, a
temperature/top-p sample otherwise), and the draft prefix is accepted
up to the first position where the drawn token differs from the draft.
For greedy this is plain argmax-matching.  For sampling it is the
token-matching coupling: with a *deterministic* drafter (a point mass
q), accepting draft d_j iff an independent sample s_j ~ p_j equals d_j
happens with probability p_j(d_j) — exactly the canonical
min(1, p/q) rule — and the emitted token at the first mismatch is s_j
itself, i.e. a fresh draw from p_j.  Every emitted token is therefore
distributed as p(. | emitted prefix): the output distribution is
IDENTICAL to plain autoregressive sampling; speculation only changes
how many tokens land per weight stream.
(Not bit-identical to the sequential loop in general: the T=k verify
runs its matmuls at another row count than the T=1 step, so a
numerically tied argmax — or the logits a sample is drawn from — can
differ at rounding level.  Both are valid rounding variants of the same
math; the same caveat applies to vLLM's spec decode.)

Replaces the decode loop of the reference's HF ``generate``
(modeling_desta25.py:1419-1427) when ``speculative_k >= 2``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import LLMConfig
from ..models import llm as jllm


def ngram_propose(hist: jnp.ndarray, hlen: jnp.ndarray,
                  k: int) -> jnp.ndarray:
    """Draft ``k`` tokens per row by longest-suffix prompt-lookup.

    hist: [B, Th] emitted-token history (prompt ids + generated), padded
    with anything past ``hlen``; hlen: [B] valid lengths (>= 1).  Finds
    the most recent earlier occurrence of the last TRIGRAM
    (hist[hlen-3:hlen]) and proposes the ``k`` tokens that followed it;
    backs off to the last bigram when no trigram recurs, and to
    repeating the last token when neither does (a free guess that still
    wins on degenerate loops).  The longer suffix disambiguates: on
    structured text ("the cat sat" vs "the dog sat") the most recent
    bigram occurrence often continues the WRONG phrase — matching one
    more token of context lifts acceptance at zero extra verify cost
    (the match is a rolled compare over [Th] on the VPU, nothing more).
    """
    B, Th = hist.shape

    def row(h, n):
        cur = h[jnp.maximum(n - 1, 0)]
        prev = h[jnp.maximum(n - 2, 0)]
        prev2 = h[jnp.maximum(n - 3, 0)]
        i_idx = jnp.arange(Th - 1)
        nxt = jnp.roll(h, -1)[:-1]    # h[i+1]
        prv = jnp.roll(h, 1)[:-1]     # h[i-1] (garbage at i=0, masked)
        match2 = (h[:-1] == prev) & (nxt == cur)
        # exclude the trailing n-gram itself and anything past history
        match2 &= (i_idx + 1) < (n - 1)
        match2 &= n >= 2
        match3 = match2 & (prv == prev2) & (i_idx >= 1) & (n >= 3)
        best3 = jnp.max(jnp.where(match3, i_idx, -1))
        best2 = jnp.max(jnp.where(match2, i_idx, -1))
        best = jnp.where(best3 >= 0, best3, best2)
        found = best >= 0
        start = jnp.clip(best + 2, 0, Th - k)
        cand = jax.lax.dynamic_slice(h, (start,), (k,))
        # matched continuation may run past the valid history; fall back
        # to repeating the last token there
        cpos = start + jnp.arange(k)
        cand = jnp.where(found & (cpos < n), cand, cur)
        return cand

    return jax.vmap(row)(hist, hlen)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "max_new_tokens", "eos_ids", "pad_id",
                     "speculative_k", "return_stats", "temperature",
                     "top_p", "do_sample", "inject_scale", "inject_heads"),
)
def llm_generate_spec(
    params,
    cfg: LLMConfig,
    inputs_embeds: jnp.ndarray,       # [B, T, D] spliced context (left-pad)
    attention_mask: jnp.ndarray,      # [B, T] 1/0
    key: Optional[jax.Array] = None,  # required when do_sample
    *,
    max_new_tokens: int,
    eos_ids: Tuple[int, ...] = (),
    pad_id: int = 0,
    speculative_k: int = 4,
    temperature: float = 1.0,
    top_p: float = 1.0,
    do_sample: bool = False,
    prompt_ids: Optional[jnp.ndarray] = None,  # [B, Tp] for n-gram lookup
    prompt_lens: Optional[jnp.ndarray] = None,  # [B]
    inject_params=None,               # ORCA deep injection
    inject_tokens=None,
    inject_scale: float = 2.5,
    inject_heads: int = 0,
    return_stats: bool = False,
) -> Tuple[jnp.ndarray, ...]:
    """Prefill + speculative decode (greedy or sampled).

    Same contract as ``llm_generate``: returns (tokens
    [B, max_new_tokens], n_generated [B]); the stop token stays in the
    output, later positions hold ``pad_id``.  ``prompt_ids`` (optional,
    e.g. the tokenized text context) seed the n-gram lookup table;
    generated tokens always extend it.  With ``do_sample`` the emitted
    distribution matches plain sampling exactly (token-matching
    coupling — see module docstring); ``key`` is required then.
    """
    B, T, D = inputs_embeds.shape
    Kd = speculative_k
    assert Kd >= 2
    if do_sample:
        assert key is not None, "do_sample spec decode needs a PRNG key"

    # ORCA deep injection: the gated cross-attention runs after every
    # decoder layer in the prefill and in every verify step
    extra_layer_fn = None
    if inject_params is not None:
        from ..models.orca import (
            gated_cross_attention_apply,
            precompute_cross_kv,
        )
        from ..ops.rope import fractional_rope_apply
        roped = fractional_rope_apply(inject_tokens, inject_scale,
                                      cfg.rope_theta)
        inj_k, inj_v = precompute_cross_kv(inject_params, roped)

        def extra_layer_fn(idx, h):
            lp = jax.tree.map(lambda x: x[idx], inject_params["layers"])
            return gated_cross_attention_apply(
                lp, h, None, inject_heads,
                cached_kv=(inj_k[idx], inj_v[idx]))

    # Kd slack: a verify step writes Kd positions from its cache index
    Tmax = T + max_new_tokens + Kd
    cache = jllm.init_kv_cache(cfg, B, Tmax, dtype=inputs_embeds.dtype)
    full_mask = jnp.zeros((B, Tmax), jnp.int32
                          ).at[:, :T].set(attention_mask)
    positions = jnp.maximum(jnp.cumsum(attention_mask, axis=1) - 1, 0)
    logits, cache, _ = jllm.llm_apply(
        params, cfg, inputs_embeds=inputs_embeds,
        attention_mask=full_mask, positions=positions,
        cache=cache, cache_index=0, extra_layer_fn=extra_layer_fn)
    last_pos = positions[:, -1]

    if do_sample:
        from .decode import sample_token
        # split (not fold_in) so tok0's stream can never alias a verify
        # step's fold_in(key, steps) stream
        key, key0 = jax.random.split(key)
        tok0 = sample_token(logits[:, -1].astype(jnp.float32), key0,
                            temperature, top_p, True)
    else:
        tok0 = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    eos_arr = jnp.asarray(eos_ids, jnp.int32) if eos_ids else None

    def is_eos(t):
        if eos_arr is None:
            return jnp.zeros(t.shape, bool)
        return jnp.any(t[..., None] == eos_arr, axis=-1)

    # mask: every slot >= T is pre-marked valid — the causal verify mask
    # only admits keys <= each draft position anyway, so this is exact
    # and saves a mask update per step.
    mask = full_mask.at[:, T:].set(1)

    # n-gram history: [prompt ids | generated tokens], padded by Kd so
    # the unclamped writes below never wrap
    Tp = 0 if prompt_ids is None else prompt_ids.shape[1]
    hist0 = jnp.full((B, Tp + max_new_tokens + Kd), -1, jnp.int32)
    if prompt_ids is not None:
        hist0 = hist0.at[:, :Tp].set(prompt_ids)
        hlen0 = (prompt_lens if prompt_lens is not None
                 else jnp.full((B,), Tp, jnp.int32)).astype(jnp.int32)
    else:
        hlen0 = jnp.zeros((B,), jnp.int32)
    hist0 = jax.vmap(
        lambda h, n, v: jax.lax.dynamic_update_slice(h, v[None], (n,))
    )(hist0, hlen0, tok0)

    out0 = jnp.full((B, max_new_tokens + Kd), pad_id, jnp.int32)
    out0 = out0.at[:, 0].set(tok0)

    state = dict(
        t=jnp.ones((B,), jnp.int32),         # emitted per row (tok0 = 1)
        cur=tok0,
        done=is_eos(tok0),
        out=out0,
        hist=hist0,
        hlen=hlen0 + 1,
        cache=cache,
        ci=jnp.full((B,), T, jnp.int32),     # next cache write slot
        pos=last_pos + 1,                    # rope position of cur
        steps=jnp.asarray(0, jnp.int32),
        accepted=jnp.asarray(0, jnp.int32),
    )

    jidx = jnp.arange(Kd)[None, :]

    def cond(s):
        return ~jnp.all(s["done"])

    def body(s):
        draft = ngram_propose(s["hist"], s["hlen"], Kd - 1)
        toks = jnp.concatenate([s["cur"][:, None], draft], axis=1)
        posn = s["pos"][:, None] + jidx
        lg, cache, _ = jllm.llm_apply(                # lg: [B, Kd, V]
            params, cfg, input_ids=toks, attention_mask=mask,
            positions=posn, cache=s["cache"], cache_index=s["ci"],
            extra_layer_fn=extra_layer_fn)
        if do_sample:
            # one draw from each position's processed distribution: the
            # accept-on-equality below IS exact speculative sampling for
            # a deterministic drafter (module docstring).  All B*Kd
            # positions draw in ONE sampler pass — per-position passes
            # would each pay a full-vocab reduction.
            from .decode import sample_token
            g = sample_token(
                lg.astype(jnp.float32).reshape(B * Kd, -1),
                jax.random.fold_in(key, s["steps"]),
                temperature, top_p, True).reshape(B, Kd)
        else:
            g = jnp.argmax(lg, -1).astype(jnp.int32)

        match = (toks[:, 1:] == g[:, :-1]).astype(jnp.int32)
        m = 1 + jnp.sum(jnp.cumprod(match, axis=1), axis=1)   # [B]
        # stop at the first accepted eos; respect the token budget
        eos_hit = is_eos(g)
        eos_pos = jnp.min(jnp.where(eos_hit & (jidx < m[:, None]),
                                    jidx, Kd), axis=1)
        m = jnp.minimum(m, eos_pos + 1)
        m = jnp.minimum(m, max_new_tokens - s["t"])
        m = jnp.where(s["done"], 0, jnp.maximum(m, 0))

        # write all Kd candidates; junk past m is pad_id and gets
        # overwritten by the next step (which starts at t + m) — the
        # out/hist buffers carry Kd slack so the unclamped DUS never
        # shifts
        emit_mask = (jidx < m[:, None]) & ~s["done"][:, None]
        emit = jnp.where(emit_mask, g, pad_id)
        out = jax.vmap(lambda b, v, i: jax.lax.dynamic_update_slice(
            b, v, (i,)))(s["out"], emit, s["t"])
        hist = jax.vmap(lambda b, v, i: jax.lax.dynamic_update_slice(
            b, v, (i,)))(s["hist"], emit, s["hlen"])

        nxt = jnp.take_along_axis(
            g, jnp.maximum(m - 1, 0)[:, None], axis=1)[:, 0]
        cur = jnp.where(s["done"], s["cur"], nxt)
        done = s["done"] | (eos_pos < m) | (s["t"] + m >= max_new_tokens)
        return dict(
            t=s["t"] + m, cur=cur, done=done, out=out, hist=hist,
            hlen=s["hlen"] + m, cache=cache, ci=s["ci"] + m,
            pos=s["pos"] + m, steps=s["steps"] + 1,
            accepted=s["accepted"] + jnp.sum(m))

    state = jax.lax.while_loop(cond, body, state)
    out = state["out"][:, :max_new_tokens]
    n_gen = jnp.sum(out != pad_id, axis=-1)
    if return_stats:
        # verify steps taken / tokens emitted across the batch — mean
        # acceptance = accepted / (steps * B_active); >1 token/step means
        # the drafter is paying off
        return out, n_gen, state["steps"], state["accepted"]
    return out, n_gen
