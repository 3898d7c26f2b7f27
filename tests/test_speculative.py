"""Speculative greedy decoding: drafting, acceptance, and trajectory
equality with plain greedy decode (the T=Kd verify runs through
``llm_apply``'s cached path)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from desta25_audio_tpu.config import LLMConfig
from desta25_audio_tpu.generate.decode import llm_generate
from desta25_audio_tpu.generate.speculative import (
    llm_generate_spec,
    ngram_propose,
)
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.ops.core import tree_cast
from desta25_audio_tpu.ops.quant import quantize_llm_params


def test_ngram_propose_matches_reference():
    hist = jnp.asarray([
        [5, 7, 9, 5, 7, 11, 3, 5, 7, 0, 0, 0],   # bigram (5,7) repeats
        [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12],  # no repeat
        [4, 4, 4, 4, 4, 0, 0, 0, 0, 0, 0, 0],     # degenerate loop
    ], jnp.int32)
    hlen = jnp.asarray([9, 12, 5], jnp.int32)
    got = np.asarray(ngram_propose(hist, hlen, 3))
    # row 0: last bigram (5,7) at 7..8; most recent earlier match at 3..4
    # -> continuation hist[5:8] = 11, 3, 5
    assert got[0].tolist() == [11, 3, 5]
    # row 1: no earlier match -> repeat last token
    assert got[1].tolist() == [12, 12, 12]
    # row 2: (4,4) at 3..4 matches at 2..3 (latest earlier) -> hist[4] = 4
    # then past-history fallback to 4
    assert got[2].tolist() == [4, 4, 4]


def test_ngram_propose_trigram_disambiguates():
    """Longest-suffix backoff: when the most recent bigram occurrence
    continues the WRONG phrase, the trigram match wins."""
    # suffix ...5,2,3: bigram (2,3) most recently at 5..6 (continues 9),
    # but the trigram (5,2,3) occurred at 0..2 (continues 7)
    hist = jnp.asarray(
        [[5, 2, 3, 7, 1, 2, 3, 9, 5, 2, 3, 0]], jnp.int32)
    hlen = jnp.asarray([11], jnp.int32)
    got = np.asarray(ngram_propose(hist, hlen, 2))
    assert got[0].tolist() == [7, 1]
    # bigram-only backoff still works when the trigram never recurs:
    # suffix ...8,2,3 — no earlier (8,2,3), latest (2,3) continues 9
    hist2 = jnp.asarray(
        [[5, 2, 3, 7, 1, 2, 3, 9, 8, 2, 3, 0]], jnp.int32)
    got2 = np.asarray(ngram_propose(hist2, hlen, 2))
    assert got2[0].tolist() == [9, 8]


def _nano_cfg():
    return LLMConfig(
        model_id="test/spec-nano", vocab_size=512, hidden_size=512,
        intermediate_size=768, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, rope_scaling=None, tie_word_embeddings=False,
        qk_norm=False, bos_token_id=0, eos_token_id=1)


@pytest.mark.parametrize("kd", [2, 4])
def test_spec_trajectory_equals_plain_greedy(kd, rng):
    """The speculative loop must emit EXACTLY the plain greedy trajectory
    (acceptance compares drafts against the verify pass's own argmax)."""
    cfg = _nano_cfg()
    params = jllm.init_llm(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
    qp = quantize_llm_params(tree_cast(params, jnp.bfloat16))
    B, T, MAX_NEW = 2, 12, 10
    ids = jnp.asarray(rng.integers(2, 500, size=(B, T)), jnp.int32)
    embeds = qp["embed"][ids]
    amask = jnp.ones((B, T), jnp.int32)
    # no eos in range: the nano model never emits id 1 reliably; the
    # eos early-stop variant runs on the kd=4 param only
    variants = ((),) if kd == 2 else ((int(np.asarray(ids)[0, 0]),),)
    for eos_ids in variants:
        ref, ref_n = llm_generate(
            qp, cfg, embeds, amask, jax.random.PRNGKey(0),
            max_new_tokens=MAX_NEW, do_sample=False, eos_ids=eos_ids,
            pad_id=0)
        got, got_n = llm_generate_spec(
            qp, cfg, embeds, amask, max_new_tokens=MAX_NEW,
            eos_ids=eos_ids, pad_id=0, speculative_k=kd,
            prompt_ids=ids, prompt_lens=jnp.full((B,), T, jnp.int32))
        assert np.array_equal(np.asarray(ref_n), np.asarray(got_n)), (
            eos_ids, np.asarray(ref), np.asarray(got))
        r, g = np.asarray(ref), np.asarray(got)
        for b in range(B):
            n = int(np.asarray(ref_n)[b])
            assert r[b, :n].tolist() == g[b, :n].tolist(), (eos_ids, b)


def test_spec_sampled_tiny_temperature_matches_greedy(rng):
    """Token-matching speculative SAMPLING: at temperature -> 0 every
    per-position draw collapses to the argmax, so the sampled spec loop
    must reproduce the greedy spec trajectory exactly — this pins the
    coupling wiring (per-position keys, acceptance on sampled tokens,
    sampled tok0) without a flaky statistical assertion."""
    cfg = _nano_cfg()
    params = jllm.init_llm(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
    qp = quantize_llm_params(tree_cast(params, jnp.bfloat16))
    B, T, MAX_NEW = 2, 12, 10
    ids = jnp.asarray(rng.integers(2, 500, size=(B, T)), jnp.int32)
    embeds = qp["embed"][ids]
    amask = jnp.ones((B, T), jnp.int32)
    ref, ref_n = llm_generate_spec(
        qp, cfg, embeds, amask, max_new_tokens=MAX_NEW, eos_ids=(),
        pad_id=0, speculative_k=4, prompt_ids=ids,
        prompt_lens=jnp.full((B,), T, jnp.int32))
    got, got_n = llm_generate_spec(
        qp, cfg, embeds, amask, jax.random.PRNGKey(11),
        max_new_tokens=MAX_NEW, eos_ids=(), pad_id=0, speculative_k=4,
        temperature=1e-4, top_p=1.0, do_sample=True,
        prompt_ids=ids, prompt_lens=jnp.full((B,), T, jnp.int32))
    assert np.array_equal(np.asarray(ref_n), np.asarray(got_n))
    assert np.array_equal(np.asarray(ref), np.asarray(got))


def test_spec_sampled_requires_key():
    cfg = _nano_cfg()
    params = jllm.init_llm(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
    qp = quantize_llm_params(tree_cast(params, jnp.bfloat16))
    ids = jnp.asarray([[3, 9, 3, 9]], jnp.int32)
    with pytest.raises(AssertionError):
        llm_generate_spec(
            qp, cfg, qp["embed"][ids], jnp.ones((1, 4), jnp.int32),
            max_new_tokens=4, pad_id=0, speculative_k=4,
            do_sample=True)


def test_spec_accepts_multiple_tokens_on_repetitive_text():
    """On a context that the model continues repetitively, the loop should
    finish in fewer verify steps than tokens (acceptance > 1/step)."""
    cfg = _nano_cfg()
    params = jllm.init_llm(jax.random.PRNGKey(9), cfg, dtype=jnp.float32)
    qp = quantize_llm_params(tree_cast(params, jnp.bfloat16))
    B, MAX_NEW = 1, 16
    # random nano weights produce near-cyclic greedy continuations, which
    # is exactly what the bigram drafter exploits; count steps via the
    # probe counters exposed on the loop state
    ids = jnp.asarray([[3, 9, 3, 9, 3, 9, 3, 9]], jnp.int32)
    embeds = qp["embed"][ids]
    amask = jnp.ones((B, ids.shape[1]), jnp.int32)
    out, n, steps, accepted = llm_generate_spec(
        qp, cfg, embeds, amask, max_new_tokens=MAX_NEW, eos_ids=(),
        pad_id=0, speculative_k=4, prompt_ids=ids,
        prompt_lens=jnp.full((B,), ids.shape[1], jnp.int32),
        return_stats=True)
    assert int(np.asarray(n)[0]) == MAX_NEW
    # acceptance must beat 1 token/step on a cyclic continuation (exact
    # trajectory equality vs the sequential loop is NOT asserted here:
    # near-tie argmaxes may resolve differently between the T=Kd verify
    # and the T=1 step — see the generate/speculative.py docstring)
    assert int(np.asarray(steps)) < MAX_NEW - 1, (
        int(np.asarray(steps)), np.asarray(out))


def test_generate_speculative_e2e(tmp_path):
    """model.generate(speculative_k=4) through the audio pipeline: output
    must match plain greedy generate (int8 nano LLM)."""
    from desta25_audio_tpu import DeSTA25AudioModel, DeSTA25Config
    from desta25_audio_tpu.audio.io import write_wav

    cfg = DeSTA25Config(
        llm_model_id="test/llama-nano128",
        encoder_model_id="test/whisper-nano",
        prompt_size=8, qformer_num_hidden_layers=2, dtype="bfloat16",
        llm_quant="int8")
    model = DeSTA25AudioModel(cfg, seed=0)
    t = np.arange(12000) / 16000.0
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    p = str(tmp_path / "tone.wav")
    write_wav(p, sig)
    msgs = [{"role": "user", "content": "Describe: <|AUDIO|>",
             "audios": [{"audio": p, "text": "a tone"}]}]
    ref = model.generate(msgs, do_sample=False, max_new_tokens=5,
                         speculative_k=0)
    got = model.generate(msgs, do_sample=False, max_new_tokens=5,
                         speculative_k=4)
    assert got.text == ref.text, (got.text, ref.text)

    # text-only path with prompt-id seeded lookup
    tmsgs = [{"role": "user", "content": "hello hello hello hello"}]
    ref_t = model.generate(tmsgs, do_sample=False, max_new_tokens=6,
                           speculative_k=0)
    got_t = model.generate(tmsgs, do_sample=False, max_new_tokens=6,
                           speculative_k=4)
    assert got_t.text == ref_t.text

    # sampled speculative generate (token-matching coupling): at
    # temperature -> 0 every draw is the argmax, so the output must
    # match greedy — proves generate() no longer falls back on do_sample
    got_s = model.generate(msgs, do_sample=True, temperature=1e-4,
                           top_p=1.0, max_new_tokens=5, speculative_k=4)
    assert got_s.text == ref.text, (got_s.text, ref.text)
