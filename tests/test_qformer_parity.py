"""Q-Former (BERT encoder w/ cross-attn) parity vs HF BertEncoder, and
connector shape/semantics tests mirroring the reference's
tests/test_modeling.py (mock encoder hidden states)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from desta25_audio_tpu.config import DeSTA25Config, QFormerConfig
from desta25_audio_tpu.ckpt.hf_convert import convert_bert_encoder_state
from desta25_audio_tpu.models import qformer as q

torch = pytest.importorskip("torch")

jax.config.update("jax_default_matmul_precision", "highest")


def test_bert_encoder_parity(rng):
    from transformers import BertConfig
    from transformers.models.bert.modeling_bert import BertEncoder

    hf_cfg = BertConfig()
    hf_cfg.num_hidden_layers = 2
    hf_cfg.num_attention_heads = 2
    hf_cfg.hidden_size = 64
    hf_cfg.add_cross_attention = True
    hf_cfg.is_decoder = True
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    enc = BertEncoder(hf_cfg).eval()

    cfg = QFormerConfig(hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=3072)
    params = convert_bert_encoder_state(enc.state_dict(), 2)

    queries = rng.standard_normal((3, 8, 64)).astype(np.float32)
    cross = rng.standard_normal((3, 20, 64)).astype(np.float32)
    with torch.no_grad():
        ref = enc(torch.tensor(queries),
                  encoder_hidden_states=torch.tensor(cross)
                  ).last_hidden_state.numpy()
    got = np.asarray(q.bert_encoder_apply(
        params, jnp.asarray(queries), jnp.asarray(cross), cfg))
    assert np.max(np.abs(got - ref)) < 2e-5


@pytest.fixture()
def nano_cfg():
    return DeSTA25Config(
        llm_model_id="test/llama-nano",
        encoder_model_id="test/whisper-nano",
        connector_mode="qformer_1",
        qformer_num_hidden_layers=2,
        prompt_size=8,
    )


def test_connector_shapes(nano_cfg, rng):
    """Mirrors reference tests/test_modeling.py:23-36 — mock hidden states."""
    cfg = nano_cfg
    params = q.init_qformer_connector(jax.random.PRNGKey(0), cfg)
    n_taps = len(cfg.target_layer_ids)
    taps = jnp.asarray(rng.standard_normal(
        (n_taps, 2, 30, cfg.encoder_config.d_model)).astype(np.float32))
    out = q.qformer_connector_apply(params, taps, cfg)
    assert out.shape == (2, cfg.prompt_size, cfg.llm_config.hidden_size)
    assert not np.isnan(np.asarray(out)).any()


def test_connector_layer_weight_fusion(nano_cfg):
    """Softmax fusion invariance: identical taps + identical prompts ->
    the fused pre-projection output equals a single Q-Former pass (softmax
    weights sum to 1 regardless of their values)."""
    cfg = nano_cfg
    rng = np.random.default_rng(1)
    params = q.init_qformer_connector(jax.random.PRNGKey(0), cfg)
    n_taps = len(cfg.target_layer_ids)
    tap = rng.standard_normal(
        (1, 2, 30, cfg.encoder_config.d_model)).astype(np.float32)
    taps_same = jnp.asarray(np.repeat(tap, n_taps, axis=0))
    p2 = dict(params)
    p2["layer_prompts"] = jnp.repeat(params["layer_prompts"][:1], n_taps, 0)
    # give the weights an arbitrary non-zero value to prove invariance
    p2["layer_weights"] = jnp.asarray(
        rng.standard_normal(params["layer_weights"].shape).astype(np.float32))
    fused = np.asarray(q.qformer_connector_apply(p2, taps_same, cfg))

    from desta25_audio_tpu.ops.core import layer_norm, linear
    queries = jnp.broadcast_to(p2["layer_prompts"][0][None],
                               (2,) + p2["layer_prompts"][0].shape)
    single = q.bert_encoder_apply(p2["qformer"], queries,
                                  jnp.asarray(tap[0]), cfg.qformer_config)
    single = linear(p2["proj"], layer_norm(p2["proj_ln"], single, 1e-5))
    assert np.max(np.abs(fused - np.asarray(single))) < 1e-5


def test_connector_mixed_precision(nano_cfg, rng):
    """bf16 params x f32 inputs must not raise (reference
    tests/test_modeling.py:161-183)."""
    cfg = nano_cfg
    from desta25_audio_tpu.ops.core import tree_cast
    params = tree_cast(
        q.init_qformer_connector(jax.random.PRNGKey(0), cfg), jnp.bfloat16)
    n_taps = len(cfg.target_layer_ids)
    taps = jnp.asarray(rng.standard_normal(
        (n_taps, 1, 30, cfg.encoder_config.d_model)).astype(np.float32))
    out = q.qformer_connector_apply(params, taps.astype(jnp.bfloat16), cfg)
    assert np.isfinite(np.asarray(out, dtype=np.float32)).all()


def test_dyn_int8_linear_close(rng):
    """dyn_int8_linear (fully-dynamic W8A8) vs the bf16 linear: per-row
    act + per-channel weight quant keeps relative error in the ~1%
    range (runs the int8 dot on CPU too — slow but exact semantics)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from desta25_audio_tpu.ops.core import dyn_int8_linear, init_linear, linear
    p = init_linear(jax.random.PRNGKey(0), 128, 96, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 64, 128), jnp.float32)
    ref = np.asarray(linear(p, x))
    got = np.asarray(dyn_int8_linear(p, x))
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 0.03, err


def test_qformer_w8a8_close():
    """The inference connector path (w8a8=True: dynamic-int8 cross K/V
    projections) must stay close to the bf16 path."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models.qformer import (
        init_qformer_connector,
        qformer_connector_apply,
    )
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="test/whisper-nano",
                        prompt_size=8, qformer_num_hidden_layers=2)
    n_taps = len(cfg.target_layer_ids)
    d_enc = cfg.encoder_config.d_model
    params = init_qformer_connector(jax.random.PRNGKey(0), cfg,
                                    dtype=jnp.bfloat16)
    taps = jax.random.normal(jax.random.PRNGKey(1),
                             (n_taps, 2, 256, d_enc), jnp.bfloat16)
    ref = np.asarray(qformer_connector_apply(params, taps, cfg,
                                             w8a8=False), np.float32)
    got = np.asarray(qformer_connector_apply(params, taps, cfg,
                                             w8a8=True), np.float32)
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6)
    assert err < 5e-2, err
