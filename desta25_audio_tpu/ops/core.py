"""Core functional NN building blocks.

The whole framework uses plain parameter pytrees (nested dicts of
``jax.Array``) with pure ``init_*`` / ``*_apply`` functions.  This keeps
sharding annotations, freezing, and checkpoint interop fully explicit — the
idiomatic pattern for GSPMD/pjit training.

Numerics policy: parameters may be stored in bfloat16; all normalization
statistics, softmax, and matmul accumulations run in float32
(``preferred_element_type``), then are cast back to the activation dtype.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def normal_init(key, shape, stddev=0.02, dtype=jnp.float32):
    return jax.random.normal(key, shape, dtype) * jnp.asarray(stddev, dtype)


def kaiming_uniform(key, shape, fan_in=None, dtype=jnp.float32):
    """torch.nn.Linear / Conv default init (kaiming uniform, a=sqrt(5))."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) == 2 else int(math.prod(shape[1:]))
    bound = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
    return jax.random.uniform(key, shape, dtype, -bound, bound)


def uniform_bias(key, shape, fan_in, dtype=jnp.float32):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return jax.random.uniform(key, shape, dtype, -bound, bound)


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------


def init_linear(key, in_dim: int, out_dim: int, use_bias: bool = True,
                dtype=jnp.float32, stddev: Optional[float] = None) -> Params:
    """Weight stored as [in_dim, out_dim] (transposed vs torch)."""
    wkey, bkey = jax.random.split(key)
    if stddev is not None:
        w = normal_init(wkey, (in_dim, out_dim), stddev, dtype)
    else:
        w = kaiming_uniform(wkey, (out_dim, in_dim), fan_in=in_dim,
                            dtype=dtype).T
    p: Params = {"w": w}
    if use_bias:
        p["b"] = uniform_bias(bkey, (out_dim,), in_dim, dtype)
    return p


def linear(p: Params, x: jnp.ndarray) -> jnp.ndarray:
    if "w" not in p:
        # int8 leaf from ops.quant.quantize_linear: {"q", "s", "b"?}
        from .quant import int8_act_matmul
        return int8_act_matmul(x, p, p.get("b"))
    y = jnp.dot(x, p["w"], preferred_element_type=jnp.float32)
    if "b" in p:
        y = y + p["b"].astype(jnp.float32)
    return y.astype(x.dtype)


def dyn_int8_linear(p: Params, x: jnp.ndarray) -> jnp.ndarray:
    """Fully-dynamic W8A8 linear: quantize BOTH operands on the fly
    (per-out-channel weight scales, per-row activation scales) and run
    an int8 x int8 -> int32 dot.

    For compute-bound big-M matmuls over bf16 weights that stay
    trainable (so offline weight quantization is off the table) — e.g.
    the Q-Former's cross K/V projections at M = n_taps*B*T_enc ~ 48k
    rows.  The weight quant pass is O(K*N) — negligible
    next to the O(M*K*N) dot.  INFERENCE ONLY: jnp.round has a zero
    gradient, so callers must keep training paths on :func:`linear`
    (the same rule as ops.quant's W8A8 prefill dispatch)."""
    w = p["w"].astype(jnp.float32)
    ws = jnp.maximum(jnp.max(jnp.abs(w), axis=0), 1e-8) / 127.0
    qw = jnp.round(w / ws[None, :]).astype(jnp.int8)
    K = x.shape[-1]
    xf = x.reshape(-1, K).astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True),
                     1e-8) / 127.0
    qx = jnp.round(xf / xs).astype(jnp.int8)
    y = jax.lax.dot_general(qx, qw, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    y = y.astype(jnp.float32) * xs * ws[None, :]
    if "b" in p:
        y = y + p["b"].astype(jnp.float32)
    return y.reshape(*x.shape[:-1], qw.shape[1]).astype(x.dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_layer_norm(dim: int, dtype=jnp.float32) -> Params:
    return {"scale": jnp.ones((dim,), dtype), "bias": jnp.zeros((dim,), dtype)}


def layer_norm(p: Params, x: jnp.ndarray, eps: float = 1e-5) -> jnp.ndarray:
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    y = y * p["scale"].astype(jnp.float32) + p["bias"].astype(jnp.float32)
    return y.astype(x.dtype)


def init_rms_norm(dim: int, dtype=jnp.float32) -> Params:
    return {"scale": jnp.ones((dim,), dtype)}


def rms_norm(p: Params, x: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    xf = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    y = xf * jax.lax.rsqrt(var + eps)
    y = y * p["scale"].astype(jnp.float32)
    return y.astype(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def gelu(x: jnp.ndarray) -> jnp.ndarray:
    # Erf-based gelu: matches torch.nn.functional.gelu default used by
    # Whisper (modeling_desta25.py:563-564) and BERT.
    return jax.nn.gelu(x, approximate=False)


def silu(x: jnp.ndarray) -> jnp.ndarray:
    return jax.nn.silu(x)


# ---------------------------------------------------------------------------
# Attention (the plain reference; ops/attention.py is the model's dispatch)
# ---------------------------------------------------------------------------


def mha(q: jnp.ndarray, k: jnp.ndarray, v: jnp.ndarray,
        bias: Optional[jnp.ndarray] = None,
        mask: Optional[jnp.ndarray] = None,
        scale: Optional[float] = None) -> jnp.ndarray:
    """Multi-head attention core.

    q: [B, Tq, H, D]; k/v: [B, Tk, Hkv, D] with H % Hkv == 0 (GQA).
    mask: broadcastable to [B, H, Tq, Tk]; True = attend.
    Returns [B, Tq, H, D].  Softmax in float32.
    """
    B, Tq, H, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if Hkv != H:
        rep = H // Hkv
        k = jnp.repeat(k, rep, axis=2)
        v = jnp.repeat(v, rep, axis=2)
    # explicit [B, H, T, D] layout for the batched einsums
    qt = jnp.swapaxes(q, 1, 2)
    kt = jnp.swapaxes(k, 1, 2)
    vt = jnp.swapaxes(v, 1, 2)
    logits = jnp.einsum("bhqd,bhkd->bhqk", qt, kt,
                        preferred_element_type=jnp.float32)
    logits = logits * scale
    if bias is not None:
        logits = logits + bias.astype(jnp.float32)
    if mask is not None:
        logits = jnp.where(mask, logits, jnp.float32(-1e30))
    # Deferred softmax normalization (flash-attention style): exponentiate
    # in f32, run the PV matmul on unnormalized bf16 weights, divide the
    # small [*, Tq, D] output by the row sums — halves the HBM traffic of
    # normalizing the [*, Tq, Tk] matrix in f32.
    m = jnp.max(logits, axis=-1, keepdims=True)
    e = jnp.exp(logits - m)
    den = jnp.sum(e, axis=-1, keepdims=True)
    out = jnp.einsum("bhqk,bhkd->bhqd", e.astype(v.dtype), vt,
                     preferred_element_type=jnp.float32)
    out = out / den
    return jnp.swapaxes(out, 1, 2).astype(q.dtype)


def causal_mask(Tq: int, Tk: int, offset: int = 0) -> jnp.ndarray:
    """[1, 1, Tq, Tk] boolean causal mask; query i attends keys <= i+offset."""
    qi = jnp.arange(Tq)[:, None] + offset
    ki = jnp.arange(Tk)[None, :]
    return (ki <= qi)[None, None]


# ---------------------------------------------------------------------------
# Conv1d (NCW semantics like torch, implemented over NWC)
# ---------------------------------------------------------------------------


def init_conv1d(key, in_ch: int, out_ch: int, kernel: int,
                dtype=jnp.float32) -> Params:
    wkey, bkey = jax.random.split(key)
    fan_in = in_ch * kernel
    # Stored as [kernel, in_ch, out_ch] (lax conv_general_dilated "WIO").
    w = kaiming_uniform(wkey, (kernel, in_ch, out_ch), fan_in=fan_in,
                        dtype=dtype)
    b = uniform_bias(bkey, (out_ch,), fan_in, dtype)
    return {"w": w, "b": b}


def _conv1d_raw(x, w, stride: int, padding: int,
                f32_acc: bool = True) -> jnp.ndarray:
    return jax.lax.conv_general_dilated(
        x, w, window_strides=(stride,),
        padding=[(padding, padding)],
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32 if f32_acc else None,
    )


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _conv1d_f32acc(x, w, stride: int, padding: int) -> jnp.ndarray:
    return _conv1d_raw(x, w, stride, padding)


def _conv1d_fwd(x, w, stride, padding):
    return _conv1d_raw(x, w, stride, padding), (x, w)


def _conv1d_bwd(stride, padding, res, ct):
    # lax's conv transpose requires equal operand dtypes, so with bf16
    # operands the f32 cotangent (from preferred_element_type) raises.
    # Differentiate an operand-dtype-output conv instead: the forward keeps
    # f32 accumulation; the backward accumulates in the operand dtype.
    x, w = res
    f = lambda x_, w_: _conv1d_raw(x_, w_, stride, padding, f32_acc=False)
    _, vjp = jax.vjp(f, x, w)
    return vjp(ct.astype(x.dtype))


_conv1d_f32acc.defvjp(_conv1d_fwd, _conv1d_bwd)


def conv1d(p: Params, x: jnp.ndarray, stride: int = 1,
           padding: int = 0) -> jnp.ndarray:
    """x: [B, T, C_in] -> [B, T', C_out]."""
    # conv_general_dilated requires equal operand dtypes (unlike
    # jnp.dot's promotion) — promote for the mixed bf16-act / f32-param
    # training case, return in the activation dtype like linear()
    ct = jnp.promote_types(x.dtype, p["w"].dtype)
    y = _conv1d_f32acc(x.astype(ct), p["w"].astype(ct), stride, padding)
    y = y + p["b"].astype(jnp.float32)
    return y.astype(x.dtype)


# ---------------------------------------------------------------------------
# Pytree helpers
# ---------------------------------------------------------------------------


def tree_cast(tree, dtype):
    return jax.tree.map(
        lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        tree,
    )


def count_params(tree) -> int:
    return sum(int(x.size) for x in jax.tree.leaves(tree))


def stack_layers(layer_params: Sequence[Params]) -> Params:
    """Stack per-layer param dicts into leading-axis arrays for lax.scan."""
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *layer_params)
