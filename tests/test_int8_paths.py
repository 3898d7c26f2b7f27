"""The XLA int8 paths that serve every backend: the encoder's W8A8 FFN and
attention projections (ops.core.linear on int8 leaves), the quantized
matmul's two dispatches (dequant-dot, W8A8) and its gradient rule."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from desta25_audio_tpu.models import whisper as jw
from desta25_audio_tpu.ops import quant
from desta25_audio_tpu.ops.core import gelu, init_linear, linear


def _ffn_params(key, D, F):
    k1, k2 = jax.random.split(key)
    return init_linear(k1, D, F), init_linear(k2, F, D)


def _f32_ffn(fc1, fc2, x):
    with jax.default_matmul_precision("highest"):
        return np.asarray(linear(fc2, gelu(linear(fc1, x))))


@pytest.mark.parametrize("B,T,D,F", [(2, 30, 64, 256), (1, 75, 128, 512)])
def test_encoder_ffn_bf16_matches_f32(B, T, D, F):
    """The encoder FFN (fc1 -> erf-gelu -> fc2) in bf16, left to XLA's
    fusion, against the float32 composition."""
    fc1, fc2 = _ffn_params(jax.random.PRNGKey(0), D, F)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, T, D))
    ref = _f32_ffn(fc1, fc2, x)
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), (fc1, fc2))
    got = np.asarray(linear(bf[1], gelu(linear(bf[0], x.astype(
        jnp.bfloat16)))), np.float32)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-2


@pytest.mark.parametrize("B,T,D,F", [(2, 30, 64, 256), (1, 75, 128, 512),
                                     (3, 8, 96, 384)])
def test_encoder_ffn_w8a8_matches_dequant_f32(B, T, D, F):
    """int8 fc1/fc2 leaves run W8A8 (per-row activation quant, int8 dot)
    through ops.core.linear: close to the float32 FFN over the
    dequantized weights (the activation quant adds 1/254 of each row's
    range per matmul)."""
    fc1, fc2 = _ffn_params(jax.random.PRNGKey(2), D, F)
    q1, q2 = quant.quantize_linear(fc1), quant.quantize_linear(fc2)
    deq = [{"w": quant.dequantize_weight(q, jnp.float32), "b": q["b"]}
           for q in (q1, q2)]
    x = jax.random.normal(jax.random.PRNGKey(3), (B, T, D))
    ref = _f32_ffn(deq[0], deq[1], x)
    got = np.asarray(linear(q2, gelu(linear(q1, x))))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 3e-2


def test_encoder_int8_attention_projections_close():
    """quantize_encoder_params(attention="int8") runs q/k/v/o as W8A8:
    one encoder layer stays close to its float32 self."""
    from desta25_audio_tpu.config import DeSTA25Config
    cfg = DeSTA25Config(llm_model_id="test/llama-nano",
                        encoder_model_id="test/whisper-nano")
    ecfg = cfg.encoder_config
    ep = jw.init_whisper_encoder(jax.random.PRNGKey(4), ecfg)
    layer = jax.tree.map(lambda a: a[0], ep["layers"])
    qlayer = jax.tree.map(
        lambda a: a[0], quant.quantize_encoder_params(ep)["layers"])
    assert quant.is_quantized(qlayer["attn"]["q"])
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 50, ecfg.d_model))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jw._enc_layer_apply(
            layer, x, ecfg.encoder_attention_heads))
    got = np.asarray(jw._enc_layer_apply(qlayer, x,
                                         ecfg.encoder_attention_heads))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-2


@pytest.mark.parametrize("M,w8a8,int8_dot", [
    (4, True, False),     # decode rows: dequant-dot even with w8a8
    (127, True, False),
    (128, True, True),    # prefill rows: W8A8
    (300, False, False),  # training passes w8a8=False
])
def test_quant_matmul_dispatch(M, w8a8, int8_dot):
    K, N = 64, 48
    leaf = quant.quantize_weight(
        jax.random.normal(jax.random.PRNGKey(6), (K, N)) * 0.05)
    x = jax.random.normal(jax.random.PRNGKey(7), (M, K), jnp.bfloat16)
    hlo = jax.jit(lambda x: quant.quant_matmul(x, leaf, w8a8=w8a8)
                  ).lower(x).as_text()
    assert ("xi32>" in hlo) == int8_dot   # the int8 dot's int32 result
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(x.astype(jnp.float32)
                         @ quant.dequantize_weight(leaf, jnp.float32))
    got = np.asarray(quant.quant_matmul(x, leaf, out_dtype=jnp.float32,
                                        w8a8=w8a8))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-2


@pytest.mark.parametrize("M,w8a8", [(8, True), (256, True), (256, False)])
def test_quant_matmul_gradient_rule(M, w8a8):
    """_qmm_bwd: dx = g @ (q*s)^T on every forward dispatch (straight-
    through for the W8A8 round), against the dequantized float32 dot's
    gradient; q gets a float0 cotangent."""
    K, N = 64, 32
    leaf = quant.quantize_weight(
        jax.random.normal(jax.random.PRNGKey(8), (K, N)) * 0.05)
    w = quant.dequantize_weight(leaf, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(9), (M, K))
    g = jax.random.normal(jax.random.PRNGKey(10), (M, N))
    got = jax.grad(lambda x: jnp.sum(
        quant.quant_matmul(x, leaf, w8a8=w8a8) * g))(x)
    with jax.default_matmul_precision("highest"):
        ref = jax.grad(lambda x: jnp.sum((x @ w) * g))(x)
    # the backward dot runs in bf16 by design (quant.py _qmm_bwd)
    err = np.abs(np.asarray(got) - np.asarray(ref)).max()
    assert err / np.abs(np.asarray(ref)).max() < 2e-2
    dq = jax.grad(lambda l: jnp.sum(
        quant.quant_matmul(x, l, w8a8=w8a8) * g), allow_int=True)(leaf)
    assert dq["q"].dtype == jax.dtypes.float0
    assert not np.asarray(dq["s"]).any()
