"""int8 quantization tests: weight-only dequant-dot, W8A8, encoder and
LLM trees."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from desta25_audio_tpu.config import llm_config_for
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.ops.quant import (
    dequantize_weight,
    is_quantized,
    quant_matmul,
    quantize_llm_params,
    quantize_weight,
)


def test_quantize_roundtrip_error(rng):
    w = rng.standard_normal((64, 128)).astype(np.float32) * 0.05
    leaf = quantize_weight(jnp.asarray(w))
    assert leaf["q"].dtype == jnp.int8
    deq = np.asarray(dequantize_weight(leaf, jnp.float32))
    # max per-channel error bounded by scale/2
    scales = np.asarray(leaf["s"])
    assert (np.abs(deq - w) <= scales[None, :] * 0.5 + 1e-7).all()


def test_quant_matmul_matches_dequant(rng):
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 128)).astype(np.float32) * 0.05
    leaf = quantize_weight(jnp.asarray(w))
    got = np.asarray(quant_matmul(jnp.asarray(x), leaf))
    ref = x @ np.asarray(dequantize_weight(leaf, jnp.float32))
    assert np.max(np.abs(got - ref)) / (np.abs(ref).max() + 1e-9) < 2e-2


def test_quantized_llm_logits_close(rng):
    cfg = llm_config_for("test/llama-nano")
    params = jllm.init_llm(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    qparams = quantize_llm_params(params)
    assert is_quantized(qparams["layers"]["wq"])
    assert is_quantized(qparams["lm_head"])

    ids = rng.integers(5, cfg.vocab_size - 5, size=(2, 10)).astype(np.int32)
    ref, _, _ = jllm.llm_apply(params, cfg, input_ids=jnp.asarray(ids))
    got, _, _ = jllm.llm_apply(qparams, cfg, input_ids=jnp.asarray(ids))
    ref = np.asarray(ref)
    got = np.asarray(got)
    # logits drift bounded; top-1 agreement high
    agree = (ref.argmax(-1) == got.argmax(-1)).mean()
    assert agree > 0.9, agree


def test_quantized_tied_model_gets_lm_head():
    cfg = llm_config_for("test/qwen3-nano")
    params = jllm.init_llm(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    assert "lm_head" not in params  # tied
    qparams = quantize_llm_params(params)
    assert is_quantized(qparams["lm_head"])
    # logits path must use the quantized head and still run
    ids = jnp.ones((1, 4), jnp.int32)
    logits, _, _ = jllm.llm_apply(qparams, cfg, input_ids=ids)
    assert np.isfinite(np.asarray(logits)).all()


def test_quantized_decode_runs(rng):
    from desta25_audio_tpu.generate.decode import llm_generate
    cfg = llm_config_for("test/llama-nano")
    params = jllm.init_llm(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    qparams = quantize_llm_params(params)
    ids = rng.integers(5, 500, size=(1, 6)).astype(np.int32)
    embeds = jllm.embed_tokens(qparams, jnp.asarray(ids))
    tokens, _ = llm_generate(qparams, cfg, embeds,
                             jnp.ones((1, 6), jnp.int32),
                             jax.random.PRNGKey(0), max_new_tokens=4,
                             do_sample=False, eos_ids=(), pad_id=0)
    assert np.asarray(tokens).shape == (1, 4)


# ---------------------------------------------------------------------------
# Activation-dynamic int8 (encoder path)
# ---------------------------------------------------------------------------


def test_int8_act_matmul_close(rng):
    from desta25_audio_tpu.ops.core import init_linear, linear
    from desta25_audio_tpu.ops.quant import int8_act_matmul, quantize_linear
    p = init_linear(jax.random.PRNGKey(0), 64, 96, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 10, 64), jnp.float32)
    ref = linear(p, x)
    q = quantize_linear(p)
    got = int8_act_matmul(x, q, q.get("b"))
    # and via the linear() dispatch (leaf without "w")
    got2 = linear(q, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(got2))
    err = np.abs(np.asarray(got) - np.asarray(ref)).max()
    scale = np.abs(np.asarray(ref)).max()
    assert err < 0.03 * scale, (err, scale)


def test_quantized_encoder_close(rng):
    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models import whisper as jw
    from desta25_audio_tpu.ops.quant import quantize_encoder_params
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="test/whisper-nano")
    enc_cfg = cfg.encoder_config
    ep = jw.init_whisper_encoder(jax.random.PRNGKey(0), enc_cfg,
                                 dtype=jnp.float32)
    mel = jax.random.normal(jax.random.PRNGKey(1),
                            (2, enc_cfg.expected_mel_frames,
                             enc_cfg.num_mel_bins), jnp.float32)
    ref, taps_ref = jw.whisper_encoder_apply(ep, mel, enc_cfg, (0,))
    qp = quantize_encoder_params(ep, attention="int8")
    got, taps = jw.whisper_encoder_apply(qp, mel, enc_cfg, (0,))
    assert got.shape == ref.shape and taps.shape == taps_ref.shape
    err = np.abs(np.asarray(got) - np.asarray(ref)).max()
    scale = np.abs(np.asarray(ref)).max()
    # int8 per-layer error compounds through the residual stream; the
    # output is LayerNormed so relative tolerance is meaningful
    assert err < 0.15 * scale, (err, scale)


def test_encoder_quant_config_wiring():
    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models.desta import DeSTA25AudioModel
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="test/whisper-nano",
                        encoder_quant="int8")
    m = DeSTA25AudioModel(cfg, seed=0)
    lay = m.params["whisper"]["encoder"]["layers"]
    assert "q" in lay["fc1"] and "w" not in lay["fc1"]
    assert lay["fc1"]["q"].dtype == jnp.int8
    # attention projections are int8 too (W8A8 through ops.core.linear)
    assert "q" in lay["attn"]["q"] and "w" not in lay["attn"]["q"]
    assert lay["attn"]["q"]["q"].dtype == jnp.int8
    # generate still runs end-to-end on the quantized encoder
    out = m.generate(messages=[{"role": "user", "content": "hi"}],
                     max_new_tokens=4, do_sample=False)
    assert len(out.text) == 1


@pytest.mark.chip
def test_full_scale_int8_encoder_close(chip):
    """The complete int8 encoder (W8A8 FFN and attention projections,
    whisper-large-v3 shapes) must stay close to bf16 before the runbook
    benchmarks it against the reference's bf16 MMAU 65.21 — the analogue
    of the W8A8-prefill closeness gate."""
    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models import whisper as jw
    from desta25_audio_tpu.ops.quant import quantize_encoder_params
    from desta25_audio_tpu.utils.fast_init import random_tree_like
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="openai/whisper-large-v3")
    enc_cfg = cfg.encoder_config
    ep = random_tree_like(
        jax.random.PRNGKey(0),
        lambda k: jw.init_whisper_encoder(k, enc_cfg, dtype=jnp.bfloat16),
        scale=0.02)
    mel = (jax.random.normal(jax.random.PRNGKey(1),
                             (1, enc_cfg.expected_mel_frames,
                              enc_cfg.num_mel_bins)) * 0.5
           ).astype(jnp.bfloat16)
    taps = (3, 7)

    def run(params):
        out, tp = jw.whisper_encoder_apply(params, mel, enc_cfg, taps)
        return out.astype(jnp.float32), tp.astype(jnp.float32)

    ref, taps_ref = jax.jit(run)(ep)
    qp = jax.jit(quantize_encoder_params)(ep)
    got, taps_got = jax.jit(run)(qp)
    for g, r in ((got, ref), (taps_got, taps_ref)):
        g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
        err = np.abs(g - r).max()
        scale = max(np.abs(r).max(), 1e-6)
        # bound matches the W8A8-prefill gate's spirit: a few % of scale
        # through 32 residual layers of int8 error
        assert err < 0.08 * scale, (err, scale)


def test_encoder_quant_auto_resolution(tmp_path):
    """encoder_quant="auto" (the default): bf16 encoder for training /
    direct construction, int8 at the inference entry (from_pretrained) —
    the r4 TTFT-default decision (VERDICT r3 #3)."""
    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models.desta import DeSTA25AudioModel
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="test/whisper-nano")
    assert cfg.encoder_quant == "auto"
    assert cfg.resolved_encoder_quant(inference=False) == "none"
    assert cfg.resolved_encoder_quant(inference=True) == "int8"
    m = DeSTA25AudioModel(cfg, seed=0)
    lay = m.params["whisper"]["encoder"]["layers"]
    assert "w" in lay["fc1"]  # training path stays bf16
    d = str(tmp_path / "ck")
    m.save_pretrained(d)
    loaded = DeSTA25AudioModel.from_pretrained(d)
    llay = loaded.params["whisper"]["encoder"]["layers"]
    assert "q" in llay["fc1"] and "q" in llay["attn"]["q"]
    out = loaded.generate(messages=[{"role": "user", "content": "hi"}],
                          max_new_tokens=4, do_sample=False)
    assert len(out.text) == 1
    # explicit "none" opts out at the inference entry too
    import dataclasses as dc
    import os
    cfg_none = dc.replace(cfg, encoder_quant="none")
    with open(os.path.join(d, "config.json"), "w") as f:
        f.write(cfg_none.to_json())
    loaded2 = DeSTA25AudioModel.from_pretrained(d)
    assert "w" in loaded2.params["whisper"]["encoder"]["layers"]["fc1"]


def test_from_pretrained_config_overrides(tmp_path):
    """The runbook's int8-vs-bf16 MMAU gate (docs/real_weights.md §6b):
    from_pretrained(config_overrides={"encoder_quant": "none"}) and the
    evaluate CLI's --override flag must opt a checkpoint that defaults
    to auto/int8 back onto the bf16 encoder without editing config.json."""
    from desta25_audio_tpu.cli.evaluate import parse_overrides
    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models.desta import DeSTA25AudioModel
    assert parse_overrides(["encoder_quant=none", "audio_locator=<x>"]) == {
        "encoder_quant": "none", "audio_locator": "<x>"}
    with pytest.raises(SystemExit):
        parse_overrides(["encoder_quant"])
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="test/whisper-nano")
    d = str(tmp_path / "ck")
    DeSTA25AudioModel(cfg, seed=0).save_pretrained(d)
    loaded = DeSTA25AudioModel.from_pretrained(
        d, config_overrides=parse_overrides(["encoder_quant=none"]))
    assert loaded.config.encoder_quant == "none"
    assert "w" in loaded.params["whisper"]["encoder"]["layers"]["fc1"]


def test_w8a8_prefill_close(rng):
    """w8a8=True routes big-M quant matmuls through the activation-quant
    int8 dot; prefill logits must stay close to the weight-only
    dequant path."""
    from desta25_audio_tpu.config import LLMConfig
    from desta25_audio_tpu.models import llm as jllm
    from desta25_audio_tpu.ops.core import tree_cast
    from desta25_audio_tpu.ops.quant import quantize_llm_params

    cfg = LLMConfig(
        model_id="test/w8a8-nano", vocab_size=512, hidden_size=512,
        intermediate_size=768, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=128, rms_norm_eps=1e-5,
        rope_theta=10000.0, rope_scaling=None, tie_word_embeddings=False,
        qk_norm=False, bos_token_id=0, eos_token_id=1)
    params = jllm.init_llm(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    qp = quantize_llm_params(tree_cast(params, jnp.bfloat16))
    B, T = 4, 96  # M = 384 >= 128 -> the W8A8 branch engages
    ids = jnp.asarray(rng.integers(2, 500, size=(B, T)), jnp.int32)

    def prefill(w8a8):
        lg, _, _ = jllm.llm_apply(qp, cfg, input_ids=ids,
                                  attention_mask=jnp.ones((B, T),
                                                          jnp.int32),
                                  w8a8=w8a8)
        return np.asarray(lg, np.float32)

    ref = prefill(False)
    got = prefill(True)
    err = np.max(np.abs(ref - got)) / (np.abs(ref).max() + 1e-6)
    assert err < 5e-2, err
