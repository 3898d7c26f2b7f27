"""ops.attention: the single dispatch point of cache-less attention,
against the plain float32 reference ``ops.core.mha``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from desta25_audio_tpu.ops import attention
from desta25_audio_tpu.ops.core import mha as ref_mha


def _qkv(key, B, Tq, Tk, H, Hkv, D, dtype=jnp.float32):
    kq, kk, kv = jax.random.split(key, 3)
    return (jax.random.normal(kq, (B, Tq, H, D), dtype),
            jax.random.normal(kk, (B, Tk, Hkv, D), dtype),
            jax.random.normal(kv, (B, Tk, Hkv, D), dtype))


def _ref(q, k, v, mask=None):
    with jax.default_matmul_precision("highest"):
        return np.asarray(ref_mha(q.astype(jnp.float32),
                                  k.astype(jnp.float32),
                                  v.astype(jnp.float32), mask=mask))


@pytest.mark.parametrize("B,Tq,Tk,H,Hkv,D", [
    (2, 40, 40, 4, 4, 16),    # encoder self-attention
    (2, 8, 60, 4, 4, 16),     # Q-Former cross-attention (Tq << Tk)
    (1, 24, 24, 8, 2, 32),    # GQA, 4 query heads per kv head
    (3, 17, 33, 2, 1, 8),     # MQA, odd lengths
])
def test_mha_matches_reference(B, Tq, Tk, H, Hkv, D):
    q, k, v = _qkv(jax.random.PRNGKey(0), B, Tq, Tk, H, Hkv, D)
    got = np.asarray(attention.mha(q, k, v))
    np.testing.assert_allclose(got, _ref(q, k, v), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("padding", ["left", "right"])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_padding_and_causal_mask(padding, causal):
    B, T, H, Hkv, D = 3, 20, 4, 2, 16
    q, k, v = _qkv(jax.random.PRNGKey(1), B, T, T, H, Hkv, D)
    lens = np.array([20, 13, 6])
    kv_mask = np.zeros((B, T), np.int32)
    for b, n in enumerate(lens):
        if padding == "left":
            kv_mask[b, T - n:] = 1
        else:
            kv_mask[b, :n] = 1
    got = np.asarray(attention.mha(q, k, v, kv_mask=jnp.asarray(kv_mask),
                                   causal=causal))
    mask = np.broadcast_to(kv_mask[:, None, None, :] > 0, (B, 1, T, T))
    if causal:
        mask = mask & np.tril(np.ones((T, T), bool))[None, None]
    ref = _ref(q, k, v, jnp.asarray(mask))
    # rows with no valid key at all (causal + left padding) are undefined
    valid = mask.any(-1)[:, 0]                               # [B, T]
    np.testing.assert_allclose(got[valid], ref[valid], atol=1e-5, rtol=1e-5)


def test_mha_bf16_inputs_close_to_f32():
    """bf16 operands, f32 softmax: within bf16 rounding of the f32
    reference on unit-scale inputs."""
    q, k, v = _qkv(jax.random.PRNGKey(2), 2, 32, 32, 4, 2, 32,
                   dtype=jnp.bfloat16)
    got = attention.mha(q, k, v, causal=True)
    assert got.dtype == jnp.bfloat16
    causal = jnp.tril(jnp.ones((32, 32), bool))[None, None]
    err = np.abs(np.asarray(got, np.float32) - _ref(q, k, v, causal)).max()
    assert err < 2e-2, err


def test_mha_gradient_matches_reference():
    q, k, v = _qkv(jax.random.PRNGKey(3), 2, 12, 12, 4, 2, 8)
    kv_mask = jnp.asarray([[1] * 12, [0] * 4 + [1] * 8], jnp.int32)
    mask = (kv_mask[:, None, None, :] > 0) & jnp.tril(
        jnp.ones((12, 12), bool))[None, None]
    w = jax.random.normal(jax.random.PRNGKey(4), (2, 12, 4, 8))
    valid = mask.any(-1)[:, 0][..., None, None]

    def loss(fn):
        return lambda q, k, v: jnp.sum(jnp.where(valid, fn(q, k, v) * w, 0))

    got = jax.grad(loss(lambda q, k, v: attention.mha(
        q, k, v, kv_mask=kv_mask, causal=True)), argnums=(0, 1, 2))(q, k, v)
    with jax.default_matmul_precision("highest"):
        ref = jax.grad(loss(lambda q, k, v: ref_mha(q, k, v, mask=mask)),
                       argnums=(0, 1, 2))(q, k, v)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("platform,dtype,head_dim,tq,tk,masked,want", [
    ("gpu", jnp.bfloat16, 64, 1500, 1500, False, "cudnn"),  # encoder
    ("gpu", jnp.bfloat16, 64, 64, 1500, False, "cudnn"),    # Q-Former
    ("gpu", jnp.bfloat16, 128, 512, 512, True, "cudnn"),    # LLM prefill
    ("gpu", jnp.bfloat16, 128, 301, 301, True, "xla"),      # odd + bias
    ("gpu", jnp.bfloat16, 128, 301, 301, False, "cudnn"),   # odd, no bias
    ("gpu", jnp.float32, 64, 1500, 1500, False, "xla"),     # f32 operands
    ("gpu", jnp.bfloat16, 12, 64, 64, False, "xla"),        # head dim % 8
    ("gpu", jnp.bfloat16, 512, 64, 64, False, "xla"),       # head dim > 256
    ("cpu", jnp.bfloat16, 64, 1500, 1500, False, "xla"),    # no cuDNN
])
def test_implementation_rule(platform, dtype, head_dim, tq, tk, masked,
                             want):
    assert attention.implementation(platform, dtype, head_dim, tq, tk,
                                    masked) == want
