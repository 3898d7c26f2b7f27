"""LoRA alpha / dropout semantics (reference peft config r=16, alpha=16,
dropout 0.1 on q/k/v — modeling_desta25.py:720-729)."""

import numpy as np

import jax
import jax.numpy as jnp

from desta25_audio_tpu.config import DeSTA25Config, llm_config_for
from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.models.llm import _lora_delta


def test_lora_delta_scale_and_dropout(rng):
    x = jnp.asarray(rng.standard_normal((4, 32)).astype(np.float32))
    lp = {"a": jnp.asarray(rng.standard_normal((32, 4)).astype(np.float32)),
          "b": jnp.asarray(rng.standard_normal((4, 16)).astype(np.float32))}
    ref = np.asarray(x) @ np.asarray(lp["a"]) @ np.asarray(lp["b"])
    got1 = np.asarray(_lora_delta(x, lp, scale=1.0))
    got2 = np.asarray(_lora_delta(x, lp, scale=2.5))
    assert np.allclose(got1, ref, atol=1e-5)
    assert np.allclose(got2, 2.5 * ref, atol=1e-5)
    # eval mode (no key): dropout rate is ignored
    got3 = np.asarray(_lora_delta(x, lp, scale=1.0, dropout=0.5))
    assert np.allclose(got3, ref, atol=1e-5)
    # train mode: inverted-dropout scaling, mean preserved
    key = jax.random.PRNGKey(0)
    xs = jnp.asarray(rng.standard_normal((512, 32)).astype(np.float32))
    d = np.asarray(_lora_delta(xs, lp, scale=1.0, dropout=0.5, key=key))
    base = np.asarray(xs) @ np.asarray(lp["a"]) @ np.asarray(lp["b"])
    assert not np.allclose(d, base)
    assert abs(d.mean() - base.mean()) < 0.25 * (abs(base.mean()) + 1.0)


def test_lora_scale_flows_through_llm_apply(rng):
    cfg = llm_config_for("test/llama-nano")
    params = jllm.init_llm(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    lora = jllm.init_lora(jax.random.PRNGKey(1), cfg, rank=4)
    # B starts at zero -> make it nonzero so scale matters
    lora = jax.tree.map(
        lambda x: x + 0.05 if x.ndim == 3 and x.shape[-1] != 4 else x, lora)
    ids = jnp.asarray(rng.integers(2, cfg.vocab_size - 2, size=(2, 6)),
                      jnp.int32)
    base, _, _ = jllm.llm_apply(params, cfg, input_ids=ids)
    l1, _, _ = jllm.llm_apply(params, cfg, input_ids=ids, lora=lora,
                              lora_scale=1.0)
    l2, _, _ = jllm.llm_apply(params, cfg, input_ids=ids, lora=lora,
                              lora_scale=3.0)
    assert not np.allclose(np.asarray(base), np.asarray(l1), atol=1e-4)
    assert not np.allclose(np.asarray(l1), np.asarray(l2), atol=1e-4)
    # dropout with a key perturbs; without a key it is deterministic
    l3, _, _ = jllm.llm_apply(params, cfg, input_ids=ids, lora=lora,
                              lora_scale=1.0, lora_dropout=0.5,
                              lora_rng=jax.random.PRNGKey(7))
    l1b, _, _ = jllm.llm_apply(params, cfg, input_ids=ids, lora=lora,
                               lora_scale=1.0, lora_dropout=0.5)
    assert not np.allclose(np.asarray(l1), np.asarray(l3), atol=1e-4)
    assert np.allclose(np.asarray(l1), np.asarray(l1b), atol=1e-6)


def test_config_lora_scale_property():
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="test/whisper-nano",
                        use_lora=True, lora_rank=16, lora_alpha=16.0)
    assert cfg.lora_scale == 1.0
    cfg2 = DeSTA25Config(llm_model_id="test/llama-nano",
                         encoder_model_id="test/whisper-nano",
                         use_lora=True, lora_rank=8, lora_alpha=16.0)
    assert cfg2.lora_scale == 2.0


def test_yaml_lora_fields():
    from desta25_audio_tpu.config import config_from_yaml_model_section
    cfg = config_from_yaml_model_section({
        "llm": {"model_id": "test/llama-nano"},
        "encoder": {"model_id": "test/whisper-nano"},
        "use_lora": True, "lora_rank": 8, "lora_alpha": 32.0,
        "lora_dropout": 0.2,
    })
    assert cfg.lora_rank == 8 and cfg.lora_alpha == 32.0
    assert cfg.lora_dropout == 0.2 and cfg.lora_scale == 4.0


def test_merge_lora_matches_adapter_forward(rng):
    """peft merge_and_unload equivalent: merged weights reproduce the
    adapter forward (inference has no dropout), and the merged tree
    int8-quantizes for serving."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from desta25_audio_tpu.config import llm_config_for
    from desta25_audio_tpu.models import llm as jllm

    cfg = llm_config_for("test/llama-nano")
    params = jllm.init_llm(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    lora = jllm.init_lora(jax.random.PRNGKey(1), cfg, rank=4)
    # nonzero B so the delta is real
    lora = jax.tree.map(
        lambda x: x + 0.02 * jax.random.normal(
            jax.random.PRNGKey(2), x.shape, x.dtype), lora)
    ids = jnp.asarray(rng.integers(2, 500, size=(2, 10)), jnp.int32)

    ref, _, _ = jllm.llm_apply(params, cfg, input_ids=ids,
                               lora=lora, lora_scale=0.5)
    merged = jllm.merge_lora(params, lora, lora_scale=0.5)
    got, _, _ = jllm.llm_apply(merged, cfg, input_ids=ids)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got),
                               rtol=0, atol=2e-4)

    # quantized-base merge is rejected (wrong order)
    from desta25_audio_tpu.ops.quant import quantize_llm_params
    import pytest
    q = quantize_llm_params(jax.tree.map(
        lambda x: x.astype(jnp.bfloat16), params))
    with pytest.raises(ValueError):
        jllm.merge_lora(q, lora)


def test_model_merge_lora_for_serving(rng):
    """Model-level merge_and_unload: LoRA folded + tower quantized, and
    generate still matches the adapter model's greedy output."""
    import jax.numpy as jnp
    import numpy as np

    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models.desta import DeSTA25AudioModel
    from desta25_audio_tpu.ops.quant import is_quantized

    cfg = DeSTA25Config(
        llm_model_id="test/llama-nano",
        encoder_model_id="test/whisper-nano",
        prompt_size=4, qformer_num_hidden_layers=2,
        use_lora=True, lora_rank=4, dtype="float32")
    m = DeSTA25AudioModel(cfg, seed=0)
    # give the adapter a real delta (B starts at zero)
    import jax
    m.params["lora"] = jax.tree.map(
        lambda x: x + 0.02 * jax.random.normal(
            jax.random.PRNGKey(9), x.shape, x.dtype), m.params["lora"])
    msgs = [{"role": "user", "content": "Count to three."}]
    ref = m.generate(msgs, max_new_tokens=4, do_sample=False).text[0]
    m.merge_lora_for_serving(quantize=False)
    assert "lora" not in m.params
    got = m.generate(msgs, max_new_tokens=4, do_sample=False).text[0]
    assert got == ref
    # quantized variant runs too (trajectory may shift under int8)
    m2 = DeSTA25AudioModel(cfg, seed=0)
    m2.merge_lora_for_serving(quantize=True)
    assert is_quantized(m2.params["llm"]["layers"]["wq"])
    out = m2.generate(msgs, max_new_tokens=4, do_sample=False).text[0]
    assert isinstance(out, str)


def test_merge_lora_failure_keeps_adapters():
    """A rejected merge (already-quantized base) must not strip the LoRA
    adapters from the model."""
    import jax
    import pytest

    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models.desta import DeSTA25AudioModel

    cfg = DeSTA25Config(
        llm_model_id="test/llama-nano",
        encoder_model_id="test/whisper-nano",
        prompt_size=4, qformer_num_hidden_layers=2,
        use_lora=True, lora_rank=4, llm_quant="int8", dtype="float32")
    m = DeSTA25AudioModel(cfg, seed=0)
    with pytest.raises(ValueError):
        m.merge_lora_for_serving(quantize=False)
    assert "lora" in m.params  # adapters survived the failed merge
