"""Cached LLM decode and the multi-token speculative verify, both through
``llm_apply``'s XLA cache path, against plain references.

- cached decode (fresh-cache prefill + T=1 steps) against an uncached
  float32 forward over the same tokens, for bf16 and int8 towers, with
  and without GQA and qk-norm;
- per-row cache offsets (continuous batching) against per-row uncached
  forwards;
- the T=Kd verify against Kd sequential T=1 decode steps fed the same
  tokens: logits at every draft position and every cache write.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from desta25_audio_tpu.config import LLMConfig
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.ops.core import tree_cast
from desta25_audio_tpu.ops.quant import is_quantized, quantize_llm_params

# bf16 weights and activations against a float32 forward: a few bf16
# ulps (2^-8) of the logit scale after two layers.  int8 weights add
# their own rounding (1/254 of each channel's range) on top.
_TOL = {"bf16": 3e-2, "int8": 6e-2}


def nano_cfg(qk_norm=False, gqa=True):
    return LLMConfig(
        model_id="test/decode-nano", vocab_size=512, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2 if gqa else 4, head_dim=64, rms_norm_eps=1e-5,
        rope_theta=10000.0, rope_scaling=None, tie_word_embeddings=False,
        qk_norm=qk_norm, bos_token_id=0, eos_token_id=1)


def towers(cfg, seed=0):
    """(f32 params, tower params) for each tower kind: the f32 tree is the
    reference — for int8 towers, the dequantized weights."""
    p32 = jllm.init_llm(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    bf = tree_cast(p32, jnp.bfloat16)
    q8 = quantize_llm_params(bf)

    def deq(x):
        if is_quantized(x):
            return x["q"].astype(jnp.float32) * x["s"][..., None, :]
        return x.astype(jnp.float32)

    return {"bf16": (tree_cast(bf, jnp.float32), bf),
            "int8": (jax.tree.map(deq, q8, is_leaf=is_quantized), q8)}


def rel_err(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)


def f32_logits(params, cfg, ids, mask):
    with jax.default_matmul_precision("highest"):
        lg, _, _ = jllm.llm_apply(params, cfg, input_ids=ids,
                                  attention_mask=mask)
    return np.asarray(lg, np.float32)


@pytest.mark.parametrize("gqa", [True, False])
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("tower", ["bf16", "int8"])
def test_cached_decode_matches_uncached_f32(tower, qk_norm, gqa, rng):
    B, T_ctx, S, STEPS = 2, 7, 32, 3
    cfg = nano_cfg(qk_norm, gqa)
    ref_p, p = towers(cfg)[tower]
    ids = jnp.asarray(rng.integers(2, 500, size=(B, T_ctx + STEPS)),
                      jnp.int32)
    ref = f32_logits(ref_p, cfg, ids, jnp.ones(ids.shape, jnp.int32))

    cache = jllm.init_kv_cache(cfg, B, S, dtype=jnp.bfloat16)
    mask = jnp.zeros((B, S), jnp.int32).at[:, :T_ctx].set(1)
    lg, cache, _ = jllm.llm_apply(p, cfg, input_ids=ids[:, :T_ctx],
                                  attention_mask=mask, cache=cache,
                                  cache_index=0)
    assert rel_err(lg, ref[:, :T_ctx]) < _TOL[tower]
    for t in range(T_ctx, T_ctx + STEPS):
        mask = mask.at[:, t].set(1)
        lg, cache, _ = jllm.llm_apply(
            p, cfg, input_ids=ids[:, t:t + 1], attention_mask=mask,
            positions=jnp.full((B, 1), t, jnp.int32), cache=cache,
            cache_index=t)
        assert rel_err(lg[:, 0], ref[:, t]) < _TOL[tower], t
    # nothing written past the last step
    assert not np.asarray(cache.k[:, :, T_ctx + STEPS:]).any()


@pytest.mark.parametrize("tower", ["bf16", "int8"])
def test_cached_decode_per_row_cache_index(tower, rng):
    """Continuous-batching shape: every row decodes at its own offset,
    with its own valid prefix length."""
    B, S = 3, 32
    cfg = nano_cfg()
    ref_p, p = towers(cfg, seed=1)[tower]
    ctx = np.array([5, 9, 3], np.int32)
    ids = np.asarray(rng.integers(2, 500, size=(B, 16)), np.int32)
    cache = jllm.init_kv_cache(cfg, B, S, dtype=jnp.bfloat16)
    _, cache, _ = jllm.llm_apply(
        p, cfg, input_ids=jnp.asarray(ids),
        attention_mask=jnp.zeros((B, S), jnp.int32).at[:, :16].set(1),
        cache=cache, cache_index=0)
    tok = rng.integers(2, 500, size=(B,)).astype(np.int32)
    mask = np.zeros((B, S), np.int32)
    for b in range(B):
        mask[b, :ctx[b] + 1] = 1
    lg, cache, _ = jllm.llm_apply(
        p, cfg, input_ids=jnp.asarray(tok)[:, None],
        attention_mask=jnp.asarray(mask),
        positions=jnp.asarray(ctx)[:, None], cache=cache,
        cache_index=jnp.asarray(ctx))
    for b in range(B):
        seq = np.concatenate([ids[b, :ctx[b]], tok[b:b + 1]])[None]
        ref = f32_logits(ref_p, cfg, jnp.asarray(seq),
                         jnp.ones(seq.shape, jnp.int32))
        assert rel_err(lg[b, 0], ref[0, -1]) < _TOL[tower], b


@pytest.mark.parametrize("tower", ["bf16", "int8"])
@pytest.mark.parametrize("kd", [2, 3, 4, 5])
def test_verify_matches_sequential_decode(kd, tower, rng):
    """One T=Kd cached call (per-row offsets, as the speculative loops
    issue it) against Kd sequential T=1 steps over the same tokens."""
    B, T_ctx, S = 2, 6, 32
    cfg = nano_cfg(qk_norm=True)
    _, p = towers(cfg, seed=3)[tower]
    ids = jnp.asarray(rng.integers(2, 500, size=(B, T_ctx)), jnp.int32)
    toks = jnp.asarray(rng.integers(2, 500, size=(B, kd)), jnp.int32)
    cache0 = jllm.init_kv_cache(cfg, B, S, dtype=jnp.bfloat16)
    # every slot past the prefix pre-marked valid: causality alone limits
    # each draft position to its predecessors
    mask = jnp.ones((B, S), jnp.int32)
    _, cache0, _ = jllm.llm_apply(p, cfg, input_ids=ids,
                                  attention_mask=mask, cache=cache0,
                                  cache_index=0)
    ci = jnp.full((B,), T_ctx, jnp.int32)
    got, got_cache, _ = jllm.llm_apply(
        p, cfg, input_ids=toks, attention_mask=mask,
        positions=ci[:, None] + jnp.arange(kd)[None, :], cache=cache0,
        cache_index=ci)

    cache = cache0
    for j in range(kd):
        lg, cache, _ = jllm.llm_apply(
            p, cfg, input_ids=toks[:, j:j + 1], attention_mask=mask,
            positions=(ci + j)[:, None], cache=cache, cache_index=ci + j)
        # same math at another matmul row count: f32 accumulation
        # rounded to bf16 activations, so a few bf16 ulps
        assert rel_err(got[:, j], lg[:, 0]) < 2e-2, j
    for g, r in ((got_cache.k, cache.k), (got_cache.v, cache.v)):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(r, np.float32),
                                   rtol=2e-2, atol=2e-2)
    changed = np.abs(np.asarray(got_cache.k, np.float32)
                     - np.asarray(cache0.k, np.float32)).sum(axis=(0, 3))
    assert (changed[:, T_ctx:T_ctx + kd] > 0).all()
    assert (changed[:, T_ctx + kd:] == 0).all()
