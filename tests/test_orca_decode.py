"""ORCA deep-injection decode through ``llm_apply``'s ``extra_layer_fn``.

The gated cross-attention (models/orca.py gated_cross_attention_apply;
reference modeling_desta25.py:359-490) runs after every decoder layer in
prefill, in each cached decode step and in the T=Kd speculative verify.
These tests hold the cached path to an uncached float32 forward with the
same injection, and the serving paths to plain decode.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from desta25_audio_tpu.models import llm as jllm
from desta25_audio_tpu.models.orca import (
    gated_cross_attention_apply,
    precompute_cross_kv,
)
from desta25_audio_tpu.ops.core import (
    init_layer_norm,
    init_linear,
    stack_layers,
)
from desta25_audio_tpu.ops.quant import (
    is_quantized,
    quantize_llm_params,
    quantize_orca_cross_attns,
)

from test_xla_decode import nano_cfg, rel_err, towers


def _init_xattn(key, cfg, gate_init=0.25):
    """Mirror models/orca.init_orca_cross_attns, with a RANDOM gate2
    weight (the zero init would make the gate path untestable)."""
    d = cfg.hidden_size
    layers = []
    for _ in range(cfg.num_hidden_layers):
        key, kq, kk, kv, ko, kg1, kg2 = jax.random.split(key, 7)
        layers.append({
            "q": init_linear(kq, d, d),
            "k": init_linear(kk, d, d),
            "v": init_linear(kv, d, d),
            "o": init_linear(ko, d, d),
            "gate1": init_linear(kg1, d, d // 4),
            "gate2": {"w": jax.random.normal(kg2, (d // 4, 1),
                                             jnp.float32) * 0.2,
                      "b": jnp.full((1,), gate_init, jnp.float32)},
            "ln": init_layer_norm(d),
        })
    return {"layers": stack_layers(layers)}


def _dequant_xattn(xattn):
    def deq(x):
        if not is_quantized(x):
            return x
        out = {"w": x["q"].astype(jnp.float32) * x["s"][..., None, :]}
        if "b" in x:
            out["b"] = x["b"]
        return out
    return jax.tree.map(deq, xattn, is_leaf=is_quantized)


def setup_orca(cfg, B, Ta, seed=0, tower="int8"):
    """(f32 reference tower, tower, int8 xattn stack, (inj_k, inj_v)) with
    random audio tokens.  The reference tower is the dequantized one."""
    kp, kx, ka = jax.random.split(jax.random.PRNGKey(seed), 3)
    ref_p, p = towers(cfg, seed)[tower]
    xattn = quantize_orca_cross_attns(_init_xattn(ka, cfg))
    audio = (jax.random.normal(kx, (B, Ta, cfg.hidden_size),
                               jnp.float32) * 0.3).astype(jnp.bfloat16)
    inj_k, inj_v = precompute_cross_kv(xattn, audio)
    return ref_p, p, xattn, (inj_k.astype(jnp.bfloat16),
                             inj_v.astype(jnp.bfloat16))


def xla_inject_fn(xattn, inj_k, inj_v, heads, on):
    def fn(idx, h):
        lp = jax.tree.map(lambda x: x[idx], xattn["layers"])
        out = gated_cross_attention_apply(
            lp, h, None, heads, cached_kv=(inj_k[idx], inj_v[idx]))
        return jnp.where(on[:, None, None] > 0, out, h)
    return fn


def _f32_inject_fn(xattn, inj_k, inj_v, heads, on):
    x32 = _dequant_xattn(xattn)
    return xla_inject_fn(x32, inj_k.astype(jnp.float32),
                         inj_v.astype(jnp.float32), heads, on)


@pytest.mark.parametrize("tower", ["bf16", "int8"])
@pytest.mark.parametrize("H,Hkv,Ta", [
    (4, 2, 24),    # injection head dim 64
    (8, 4, 20),    # injection head dim 32
    (2, 2, 17),    # injection head dim 128, odd audio length
])
def test_inject_decode_matches_uncached_f32(H, Hkv, Ta, tower, rng):
    """Fresh-cache prefill and two cached steps, with injection on for
    row 0 and off for row 1, against an uncached float32 forward."""
    import dataclasses
    B, T_ctx, S = 2, 8, 32
    cfg = dataclasses.replace(nano_cfg(), num_attention_heads=H,
                              num_key_value_heads=Hkv,
                              head_dim=256 // H)
    ref_p, p, xattn, (inj_k, inj_v) = setup_orca(cfg, B, Ta, tower=tower)
    on = jnp.asarray([1.0, 0.0], jnp.float32)
    fn = xla_inject_fn(xattn, inj_k, inj_v, H, on)
    ids = jnp.asarray(rng.integers(2, 500, size=(B, T_ctx + 2)), jnp.int32)
    with jax.default_matmul_precision("highest"):
        ref, _, _ = jllm.llm_apply(
            ref_p, cfg, input_ids=ids,
            attention_mask=jnp.ones(ids.shape, jnp.int32),
            extra_layer_fn=_f32_inject_fn(xattn, inj_k, inj_v, H, on))

    cache = jllm.init_kv_cache(cfg, B, S, dtype=jnp.bfloat16)
    mask = jnp.zeros((B, S), jnp.int32).at[:, :T_ctx].set(1)
    _, cache, _ = jllm.llm_apply(p, cfg, input_ids=ids[:, :T_ctx],
                                 attention_mask=mask, cache=cache,
                                 cache_index=0, extra_layer_fn=fn)
    for t in (T_ctx, T_ctx + 1):
        mask = mask.at[:, t].set(1)
        lg, cache, _ = jllm.llm_apply(
            p, cfg, input_ids=ids[:, t:t + 1], attention_mask=mask,
            positions=jnp.full((B, 1), t, jnp.int32), cache=cache,
            cache_index=t, extra_layer_fn=fn)
        assert rel_err(lg[:, 0], ref[:, t]) < 6e-2, t


def test_inject_off_rows_match_plain_decode(rng):
    """Rows with on=0 decode exactly like the injection-free model (the
    select is a no-op, not a perturbation)."""
    B, T_ctx, S, Ta = 2, 6, 32, 16
    cfg = nano_cfg()
    _, p, xattn, (inj_k, inj_v) = setup_orca(cfg, B, Ta, seed=3)
    ids = jnp.asarray(rng.integers(2, 500, size=(B, T_ctx)), jnp.int32)
    mask = jnp.zeros((B, S), jnp.int32).at[:, :T_ctx + 1].set(1)
    cache = jllm.init_kv_cache(cfg, B, S, dtype=jnp.bfloat16)
    _, cache, _ = jllm.llm_apply(p, cfg, input_ids=ids,
                                 attention_mask=mask, cache=cache,
                                 cache_index=0)
    tok = jnp.asarray(rng.integers(2, 500, size=(B, 1)), jnp.int32)
    pos = jnp.full((B, 1), T_ctx, jnp.int32)
    plain, _, _ = jllm.llm_apply(p, cfg, input_ids=tok, attention_mask=mask,
                                 positions=pos, cache=cache,
                                 cache_index=T_ctx)
    fn = xla_inject_fn(xattn, inj_k, inj_v, cfg.num_attention_heads,
                       jnp.zeros((B,), jnp.float32))
    inj, _, _ = jllm.llm_apply(p, cfg, input_ids=tok, attention_mask=mask,
                               positions=pos, cache=cache,
                               cache_index=T_ctx, extra_layer_fn=fn)
    np.testing.assert_array_equal(np.asarray(plain), np.asarray(inj))


def test_inject_verify_matches_sequential_decode(rng):
    """Speculative verify (T=Kd) with injection: every draft position
    cross-attends the audio, matching Kd sequential injected steps."""
    B, T_ctx, S, Kd, Ta = 2, 8, 32, 3, 16
    cfg = nano_cfg()
    _, p, xattn, (inj_k, inj_v) = setup_orca(cfg, B, Ta, seed=5)
    fn = xla_inject_fn(xattn, inj_k, inj_v, cfg.num_attention_heads,
                       jnp.ones((B,), jnp.float32))
    ids = jnp.asarray(rng.integers(2, 500, size=(B, T_ctx)), jnp.int32)
    toks = jnp.asarray(rng.integers(2, 500, size=(B, Kd)), jnp.int32)
    mask = jnp.ones((B, S), jnp.int32)
    cache = jllm.init_kv_cache(cfg, B, S, dtype=jnp.bfloat16)
    _, cache, _ = jllm.llm_apply(p, cfg, input_ids=ids,
                                 attention_mask=mask, cache=cache,
                                 cache_index=0, extra_layer_fn=fn)
    ci = jnp.full((B,), T_ctx, jnp.int32)
    got, _, _ = jllm.llm_apply(
        p, cfg, input_ids=toks, attention_mask=mask,
        positions=ci[:, None] + jnp.arange(Kd)[None, :], cache=cache,
        cache_index=ci, extra_layer_fn=fn)
    for j in range(Kd):
        lg, cache, _ = jllm.llm_apply(
            p, cfg, input_ids=toks[:, j:j + 1], attention_mask=mask,
            positions=(ci + j)[:, None], cache=cache, cache_index=ci + j,
            extra_layer_fn=fn)
        assert rel_err(got[:, j], lg[:, 0]) < 2e-2, j


def test_inject_per_row_cache_index(rng):
    """Injected decode at per-row cache offsets (continuous batching)
    against per-row uncached float32 forwards."""
    B, S, Ta = 3, 32, 16
    cfg = nano_cfg()
    ref_p, p, xattn, (inj_k, inj_v) = setup_orca(cfg, B, Ta, seed=9)
    H = cfg.num_attention_heads
    on = jnp.asarray([1.0, 0.0, 1.0], jnp.float32)
    fn = xla_inject_fn(xattn, inj_k, inj_v, H, on)
    ctx = np.array([5, 9, 14], np.int32)
    ids = np.asarray(rng.integers(2, 500, size=(B, 16)), np.int32)
    cache = jllm.init_kv_cache(cfg, B, S, dtype=jnp.bfloat16)
    _, cache, _ = jllm.llm_apply(
        p, cfg, input_ids=jnp.asarray(ids),
        attention_mask=jnp.zeros((B, S), jnp.int32).at[:, :16].set(1),
        cache=cache, cache_index=0, extra_layer_fn=fn)
    tok = rng.integers(2, 500, size=(B,)).astype(np.int32)
    mask = np.zeros((B, S), np.int32)
    for b in range(B):
        mask[b, :ctx[b] + 1] = 1
    lg, _, _ = jllm.llm_apply(
        p, cfg, input_ids=jnp.asarray(tok)[:, None],
        attention_mask=jnp.asarray(mask),
        positions=jnp.asarray(ctx)[:, None], cache=cache,
        cache_index=jnp.asarray(ctx), extra_layer_fn=fn)
    for b in range(B):
        seq = jnp.asarray(np.concatenate([ids[b, :ctx[b]],
                                          tok[b:b + 1]])[None])
        fb = _f32_inject_fn(xattn, inj_k[:, b:b + 1], inj_v[:, b:b + 1],
                            H, on[b:b + 1])
        with jax.default_matmul_precision("highest"):
            ref, _, _ = jllm.llm_apply(
                ref_p, cfg, input_ids=seq,
                attention_mask=jnp.ones(seq.shape, jnp.int32),
                extra_layer_fn=fb)
        assert rel_err(lg[b, 0], ref[0, -1]) < 6e-2, b


def test_engine_int8_orca_matches_generate(tmp_path):
    """Serving: an ORCA engine with int8 tower + int8 cross-attn stack
    reproduces one-shot greedy generate for an audio request and a
    text-only request (injection off) sharing the batch."""
    from desta25_audio_tpu.audio.io import write_wav
    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models.desta import DeSTA25AudioModel
    from desta25_audio_tpu.serve.engine import ContinuousBatchingEngine

    t = np.arange(12000) / 16000.0
    wav = str(tmp_path / "w.wav")
    write_wav(wav, (0.5 * np.sin(2 * np.pi * 380 * t)).astype(np.float32))
    msgs_audio = [{"role": "user", "content": "Describe: <|AUDIO|>",
                   "audios": [{"audio": wav, "text": "tone"}]}]
    msgs_text = [{"role": "user", "content": "Say hi."}]

    cfg = DeSTA25Config(
        llm_model_id="test/llama-nano128",
        encoder_model_id="test/whisper-nano",
        connector_mode="orca_hybrid",
        qformer_num_hidden_layers=2,
        orca_global_num_tokens=4,
        orca_local_downsample=4,
        orca_local_kernel_size=5,
        orca_audio_position_scale=2.5,
        dtype="bfloat16")
    m = DeSTA25AudioModel(cfg, seed=1)
    m.params["llm"] = quantize_llm_params(m.params["llm"])
    m.params["orca_cross_attns"] = quantize_orca_cross_attns(
        m.params["orca_cross_attns"])

    eng = ContinuousBatchingEngine(m, n_slots=2, max_ctx=128,
                                   max_new_tokens=4, ctx_bucket=128)
    ra = eng.submit(msgs_audio)
    rt = eng.submit(msgs_text)
    res = eng.run_until_done()
    for rid, msgs in ((ra, msgs_audio), (rt, msgs_text)):
        want = m.generate(msgs, max_new_tokens=4, do_sample=False).text[0]
        assert res[rid] == want, (res[rid], want)


def test_engine_orca_speculative_trajectory_invariant(tmp_path):
    """ORCA serving with speculative verify: greedy trajectories equal
    the plain (non-speculative) ORCA engine's, and speculation engages."""
    from desta25_audio_tpu.audio.io import write_wav
    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models.desta import DeSTA25AudioModel
    from desta25_audio_tpu.serve.engine import ContinuousBatchingEngine

    t = np.arange(12000) / 16000.0
    wav = str(tmp_path / "w.wav")
    write_wav(wav, (0.5 * np.sin(2 * np.pi * 500 * t)).astype(np.float32))
    msgs = [{"role": "user", "content": "Describe: <|AUDIO|>",
             "audios": [{"audio": wav, "text": "tone tone tone"}]}]

    cfg = DeSTA25Config(
        llm_model_id="test/llama-nano128",
        encoder_model_id="test/whisper-nano",
        connector_mode="orca_hybrid",
        qformer_num_hidden_layers=2,
        orca_global_num_tokens=4,
        orca_local_downsample=4,
        orca_local_kernel_size=5,
        orca_audio_position_scale=2.5,
        dtype="bfloat16")
    m = DeSTA25AudioModel(cfg, seed=2)
    m.params["llm"] = quantize_llm_params(m.params["llm"])
    m.params["orca_cross_attns"] = quantize_orca_cross_attns(
        m.params["orca_cross_attns"])

    def run(spec_k):
        eng = ContinuousBatchingEngine(m, n_slots=1, max_ctx=128,
                                       max_new_tokens=4, ctx_bucket=128,
                                       speculative_k=spec_k)
        assert eng.speculative_k == spec_k
        rid = eng.submit(msgs)
        return eng.run_until_done()[rid]

    assert run(3) == run(0)


def test_generate_orca_speculative_matches_plain(tmp_path):
    """model.generate(speculative_k) with ORCA and an int8 cross-attn
    stack: greedy output equals the plain loop."""
    from desta25_audio_tpu.audio.io import write_wav
    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models.desta import DeSTA25AudioModel

    t = np.arange(12000) / 16000.0
    wav = str(tmp_path / "w.wav")
    write_wav(wav, (0.5 * np.sin(2 * np.pi * 640 * t)).astype(np.float32))
    msgs = [{"role": "user", "content": "Echo echo echo: <|AUDIO|>",
             "audios": [{"audio": wav, "text": "echo echo echo"}]}]

    cfg = DeSTA25Config(
        llm_model_id="test/llama-nano128",
        encoder_model_id="test/whisper-nano",
        connector_mode="orca_hybrid",
        qformer_num_hidden_layers=2,
        orca_global_num_tokens=4,
        orca_local_downsample=4,
        orca_local_kernel_size=5,
        orca_audio_position_scale=2.5,
        dtype="bfloat16")
    m = DeSTA25AudioModel(cfg, seed=4)
    m.params["llm"] = quantize_llm_params(m.params["llm"])
    m.params["orca_cross_attns"] = quantize_orca_cross_attns(
        m.params["orca_cross_attns"])

    plain = m.generate(msgs, max_new_tokens=5, do_sample=False).text[0]
    spec = m.generate(msgs, max_new_tokens=5, do_sample=False,
                      speculative_k=3).text[0]
    assert spec == plain, (spec, plain)


def test_from_pretrained_orca_xattn_quant(tmp_path):
    """config.orca_xattn_quant="int8": from_pretrained loads the float
    trainable stack then quantizes it for serving."""
    from desta25_audio_tpu.config import DeSTA25Config
    from desta25_audio_tpu.models.desta import DeSTA25AudioModel
    cfg = DeSTA25Config(
        llm_model_id="test/llama-nano128",
        encoder_model_id="test/whisper-nano",
        connector_mode="orca_hybrid",
        qformer_num_hidden_layers=2,
        orca_global_num_tokens=4,
        orca_local_downsample=4,
        orca_local_kernel_size=5,
        orca_xattn_quant="int8",
        dtype="bfloat16")
    m = DeSTA25AudioModel(cfg, seed=1)
    # direct construction keeps float leaves (training-compatible)
    assert not is_quantized(m.params["orca_cross_attns"]["layers"]["q"])
    ck = str(tmp_path / "ck")
    m.save_pretrained(ck)

    m2 = DeSTA25AudioModel.from_pretrained(ck)
    assert is_quantized(m2.params["orca_cross_attns"]["layers"]["q"])
    out = m2.generate([{"role": "user", "content": "Hi."}],
                      max_new_tokens=3, do_sample=False).text[0]
    assert isinstance(out, str)
